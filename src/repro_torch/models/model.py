"""Public model API: ``build_model(cfg) -> Model``.

Counterpart of ``src/repro/models/model.py`` for the decoders:

    init(generator, device=)           -> params
    forward(params, batch)             -> (full logits, aux)
    loss(params, batch, ce_chunk=)     -> (scalar, metrics); chunked CE
    input_specs(batch=, seq_len=, mode=) -> meta-device stand-ins of the inputs
    prefill(params, batch, n_valid=)   -> (last_logits, caches)
    decode_step(params, caches, tokens, pos) -> (logits, caches)
    prefill_chunk(params, caches, tokens, tok_pos) -> (logits, caches)
    verify_step(params, caches, tokens, pos) -> (logits, caches)
    init_caches(batch, max_len, ring_margin=, device=) -> zeroed caches
    grow_caches(caches, max_len, ring_margin=, pos=)   -> prefill caches
                                          grown for decoding
    enc_len(seq_len)                   -> slots of a cross cache

The four serving entry points take ``aux=``, a dict like
``transformer.zero_aux()``'s, into which a stack with mixture-of-experts
blocks adds their ``balance_loss`` and ``dropped_frac`` (the reference
returns them from ``forward`` and ``loss`` only; serving drops them).
``forward`` and ``loss`` run the stack in ``full`` mode (no caches, each
cycle of layers rematerialised under ``cfg.remat``), which autograd
differentiates: training runs them under ``torch.autograd``.

``batch`` is a dict with ``"tokens"``: (B, S) int (and ``"labels"``,
(B, S) int, -1 for a position without one, for ``loss``), and for a
cross-attention arch its memory's input: ``"enc_input"`` (B, S_enc,
d_model), the encoder's frame embeddings (S_enc = ``enc_len(S)`` as the
reference's stub makes them), or ``"vision_embeds"`` (B, vision_tokens,
d_vision), the image embeddings ``vision_proj`` projects. Parameters are
a nested dict in the reference's layout (``decoder/cycles/0_attn/...``
stacked over layers, ``encoder/stack/...``), whether float tensors or
QuantizedTensor views.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device, to_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ArchConfig, apply_norm, dense, dense_init,
                                      dense_rows, embed_lookup, norm_init, softcap)
from repro_torch.models.attention import decode_pos_vector, grow_ring_cache


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, generator: torch.Generator, *, device="cuda") -> dict:
        """Random parameters from ``generator`` (which must live on
        ``device``), in the reference's tree layout: an untied
        unembedding adds ``lm_head`` (d_model, vocab), an encoder
        ``encoder`` (``stack``, its ``enc_attn`` blocks, and
        ``final_norm``), a vision arch ``vision_proj`` (d_vision,
        d_model)."""
        cfg = self.cfg
        device = resolve_device(device)
        params: dict[str, Any] = {
            "embed": 0.02 * torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                                        device=device),
            "decoder": tfm.stack_init(cfg, generator, device=device),
            "final_norm": norm_init(cfg, cfg.d_model, device=device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab, device=device)
        if cfg.enc_layers:
            params["encoder"] = {
                "stack": tfm.stack_init(self._enc_cfg(), generator, device=device),
                "final_norm": norm_init(cfg, cfg.d_model, device=device)}
        if cfg.vision_tokens:
            params["vision_proj"] = dense_init(generator, cfg.d_vision, cfg.d_model,
                                               device=device)
        return params

    def _enc_cfg(self) -> ArchConfig:
        return dataclasses.replace(self.cfg, cycle=("enc_attn",), n_layers=self.cfg.enc_layers)

    def _encode(self, params, batch) -> torch.Tensor | None:
        """The memory the decoder's cross-attention blocks read: the
        encoder stack over ``batch["enc_input"]`` then its final norm, or
        ``batch["vision_embeds"]`` through ``vision_proj``; None for an
        arch without either. Both run once, at prefill, every dense layer
        on the rows their count picks."""
        cfg = self.cfg
        mem = cfg.memory_input(0)
        if mem is None:
            return None
        if mem[0] not in batch:
            raise ValueError(f"this arch reads its cross-attention memory from "
                             f"batch[{mem[0]!r}], which is missing")
        x = torch.as_tensor(batch[mem[0]]).to(cfg.dtype)
        if cfg.enc_layers:
            x, _ = tfm.run_stack(self._enc_cfg(), params["encoder"]["stack"], x, mode="full")
            return apply_norm(cfg, params["encoder"]["final_norm"], x)
        return dense(x, params["vision_proj"], dtype=cfg.dtype)

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)

    def _unembed(self, params, x: torch.Tensor, mode: str = "prefill") -> torch.Tensor:
        """``x @ embed.T`` when tied, a transposed view of the table (no
        copy); ``x @ lm_head`` (the (K, N) layout) when untied; then the
        logit softcap (``cfg.logit_softcap``; none at 0)."""
        w = params["embed"].T if self.cfg.tie_embeddings else params["lm_head"]
        logits = dense(x.to(torch.float32), w, dtype=torch.float32, rows=dense_rows(mode))
        return softcap(logits, self.cfg.logit_softcap)

    def _hidden(self, params, batch):
        """The final-normed hidden states of a ``full`` pass (B, S, d) and
        the auxiliaries summed over the MoE blocks (zeros without any)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        aux = tfm.zero_aux(tokens.device)
        enc_out = self._encode(params, batch)
        x = self._embed(params, tokens)
        x, _ = tfm.run_stack(cfg, params["decoder"], x, mode="full", aux=aux, enc_out=enc_out)
        return apply_norm(cfg, params["final_norm"], x), aux

    def forward(self, params, batch):
        """Full logits (B, S, V) float32, softcapped, and the auxiliaries
        ``{"balance_loss", "dropped_frac"}`` (float32 scalars)."""
        x, aux = self._hidden(params, batch)
        return self._unembed(params, x), aux

    def loss(self, params, batch, *, ce_chunk: int = 512):
        """Chunked cross-entropy, never the whole (B, S, V) logits: the
        sequence in chunks of ``min(ce_chunk, S)`` positions (labels
        padded with -1), each chunk's float32 logits softcapped, the
        negative log-likelihood ``logsumexp - gold`` summed over the
        positions whose label is not negative and divided by their count
        (at least 1). Returns ``(ce + 0.01 * balance_loss, {"ce", **aux})``,
        as the reference's ``loss``."""
        cfg = self.cfg
        x, aux = self._hidden(params, batch)
        labels = torch.as_tensor(batch["labels"]).to(x.device)
        S = x.shape[1]
        C = min(ce_chunk, S)
        pad = (-S) % C
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            labels = F.pad(labels, (0, pad), value=-1)
        w = (params["embed"].T if cfg.tie_embeddings else params["lm_head"]).to(torch.float32)
        nll_sum = n_valid = torch.zeros((), device=x.device)
        for c0 in range(0, x.shape[1], C):
            ll = labels[:, c0:c0 + C]
            logits = softcap(x[:, c0:c0 + C].to(torch.float32) @ w, cfg.logit_softcap)
            gold = torch.gather(logits, -1, torch.clamp(ll, min=0).long()[..., None])[..., 0]
            valid = (ll >= 0).to(torch.float32)
            nll_sum = nll_sum + ((torch.logsumexp(logits, dim=-1) - gold) * valid).sum()
            n_valid = n_valid + valid.sum()
        ce = nll_sum / torch.clamp(n_valid, min=1.0)
        return ce + 0.01 * aux["balance_loss"], {"ce": ce, **aux}

    def input_specs(self, *, batch: int, seq_len: int, mode: str) -> dict:
        """Stand-ins for every model input on the ``meta`` device (shapes
        and dtypes, no storage), the reference's ``ShapeDtypeStruct``s.
        ``mode``: ``train`` (tokens and labels), ``prefill`` (tokens) or
        ``decode`` (one token a row); the first two add a cross-attention
        arch's memory input (``ArchConfig.memory_input``)."""
        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if mode == "train":
            specs = {"tokens": spec((batch, seq_len), torch.int32),
                     "labels": spec((batch, seq_len), torch.int32)}
        elif mode == "prefill":
            specs = {"tokens": spec((batch, seq_len), torch.int32)}
        elif mode == "decode":
            specs = {"tokens": spec((batch, 1), torch.int32)}
        else:
            raise ValueError(mode)
        mem = self.cfg.memory_input(seq_len)
        if mode != "decode" and mem is not None:
            specs[mem[0]] = spec((batch,) + mem[1], self.cfg.dtype)
        return specs

    def prefill(self, params, batch, n_valid=None, *, aux=None):
        """Logits after the last prompt token, and the prompt's caches.

        ``n_valid`` (B,) int32 (a tensor on the tokens' device, or a host
        array): the prompt is padded to a bucket and only its first
        ``n_valid[b]`` positions are real. Every row must share one valid
        length (the slot pool prefills at batch 1). Padded positions are
        masked out of attention (their keys sit at position -1) and the
        logits are gathered at row ``n_valid - 1``, on the device. A
        stack with sliding-window blocks (``swa``, ``swa_moe``) or
        recurrent blocks refuses ``n_valid``: a ring has no masked slots,
        and a recurrent state would consume the padding. Padded positions still
        run through a MoE block's router and take expert capacity after
        the real ones, whose capacity is the padded length's, as in the
        reference."""
        cfg = self.cfg
        if n_valid is not None and (any(tfm.attn_window(cfg, k) for k in cfg.cycle + cfg.tail)
                                    or tfm.recurrent_kinds(cfg)):
            raise NotImplementedError(
                "bucket-padded prefill needs position masking, which sliding-window "
                "rings and recurrent states don't support — admit at the exact prompt "
                "length instead")
        tokens = batch["tokens"]
        if n_valid is not None and not isinstance(n_valid, torch.Tensor):
            n_valid = to_device(np.asarray(n_valid, np.int32), tokens.device)
        enc_out = self._encode(params, batch)
        x = self._embed(params, tokens)
        x, caches = tfm.run_stack(cfg, params["decoder"], x, mode="prefill", pos=n_valid,
                                  aux=aux, enc_out=enc_out)
        if n_valid is None:
            xl = x[:, -1:, :]
        else:
            idx = torch.clamp(n_valid.to(torch.long) - 1, 0, x.shape[1] - 1)
            xl = x[torch.arange(x.shape[0], device=x.device), idx][:, None, :]
        xl = apply_norm(cfg, params["final_norm"], xl)
        return self._unembed(params, xl)[:, 0, :], caches

    def decode_step(self, params, caches, tokens: torch.Tensor, pos, *, aux=None):
        """tokens: (B, 1); pos: int (lock-stepped write position) or (B,)
        int32 per-slot positions (negative = free slot). Writes the
        step's K/V into ``caches`` in place and returns them."""
        cfg = self.cfg
        pos = decode_pos_vector(pos, tokens.shape[0], tokens.device)
        x = self._embed(params, tokens)
        x, caches = tfm.run_stack(cfg, params["decoder"], x, mode="decode",
                                  caches=caches, pos=pos, aux=aux)
        x = apply_norm(cfg, params["final_norm"], x)
        return self._unembed(params, x, "decode")[:, 0, :], caches

    def prefill_chunk(self, params, caches, tokens: torch.Tensor, tok_pos: torch.Tensor, *,
                      aux=None):
        """Ragged chunked prefill: consume a (B, C) block of prompt tokens
        straight into the pooled ``caches``, each slot at its own depth.
        ``tok_pos`` (B, C) int32 is token (b, t)'s prompt position;
        negative marks a masked row (a free or decoding slot riding the
        batched launch, or padding past a short final chunk), which
        writes nothing. Returns ``(logits (B, C, V), caches)``:
        logits[:, t] is the next-token distribution after prompt
        position tok_pos[:, t]."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        x, caches = tfm.run_stack(cfg, params["decoder"], x, mode="prefill_chunk",
                                  caches=caches, pos=tok_pos, aux=aux)
        x = apply_norm(cfg, params["final_norm"], x)
        return self._unembed(params, x), caches

    def verify_step(self, params, caches, tokens: torch.Tensor, pos, *, aux=None):
        """Speculative verify: score a (B, T) block in one pass. Token t of
        slot b sits at ``pos[b] + t``; a negative base masks the slot.
        Returns ``(logits (B, T, V), caches)``: logits[:, t] is exactly
        what t + 1 sequential ``decode_step`` calls would give. K/V of all
        T rows are written; rejected rows stay in place, invisible to the
        causal mask, until later rounds overwrite them.

        Unlike ``prefill_chunk``, whose dense layers take the route the
        number of rows picks (the tensor cores from 16 rows, whose rows
        depend on M), verify runs them with ``rows="decode"``, as
        ``decode_step`` does: on the card, every row of the (B*T)-row
        launches is then bit-equal to the same row launched alone, so the
        logits and the K/V rows written equal sequential decode steps' bit
        for bit, and speculative output equals plain greedy decoding
        exactly. The norms and ``flash_verify`` rows are row-independent
        too (``common.apply_norm``, the attention body)."""
        cfg = self.cfg
        pos = decode_pos_vector(pos, tokens.shape[0], tokens.device)
        x = self._embed(params, tokens)
        x, caches = tfm.run_stack(cfg, params["decoder"], x, mode="verify",
                                  caches=caches, pos=pos, aux=aux)
        x = apply_norm(cfg, params["final_norm"], x)
        return self._unembed(params, x, "verify"), caches

    def init_caches(self, batch: int, max_len: int, *, ring_margin: int = 0, device="cuda"):
        """Zeroed caches; the rings of windowed blocks hold ``window +
        ring_margin`` slots, the cross caches ``enc_len(max_len)``."""
        return tfm.stack_init_caches(self.cfg, batch, max_len, self.enc_len(max_len),
                                     ring_margin=ring_margin, device=resolve_device(device))

    def enc_len(self, seq_len: int) -> int:
        """Slots of a cross cache: the encoder's frames for a prompt of
        ``seq_len`` tokens (at least 1), or the image's ``vision_tokens``;
        0 for an arch without a memory."""
        mem = self.cfg.memory_input(seq_len)
        return 0 if mem is None else mem[1][0]

    def grow_caches(self, caches, max_len: int, *, ring_margin: int = 0, pos: int = 0):
        """Pad prefill caches of full-attention blocks (``attn``,
        ``global``, ``moe``, ``shared_attn``) along the sequence axis to
        ``max_len``. With ``ring_margin`` > 0 the rings of windowed blocks
        are repacked into ``window + ring_margin`` slots
        (``grow_ring_cache``; ``pos`` = the tokens consumed so far, the
        prompt's length), so that blocks of up to ``ring_margin`` rows
        never overwrite live window entries. Recurrent states and the
        cross caches (a ``cross`` block's, a ``selfcross`` block's
        ``cross`` part: no ``max_len`` axis) are final size and come back
        as they are; a ``selfcross`` block's ``self`` part is padded."""
        cfg = self.cfg

        def pad(a: torch.Tensor) -> torch.Tensor:
            S = a.shape[-2]
            if S >= max_len:
                return a
            out = a.new_zeros(a.shape[:-2] + (max_len, a.shape[-1]))
            out[..., :S, :] = a
            return out

        def grow(kind: str, c: dict) -> dict:
            if kind == "selfcross":
                return {"self": _map(pad, c["self"]), "cross": c["cross"]}
            if kind in tfm.FULL_KV_KINDS:
                return _map(pad, c)
            if tfm.attn_window(cfg, kind) and ring_margin:
                return grow_ring_cache(c, cfg.window + ring_margin, pos)
            return c

        return {part: {f"{j}_{kind}": grow(kind, caches[part][f"{j}_{kind}"])
                       for j, kind in enumerate(kinds) if f"{j}_{kind}" in caches[part]}
                for part, kinds in (("cycles", cfg.cycle), ("tail", cfg.tail))}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
