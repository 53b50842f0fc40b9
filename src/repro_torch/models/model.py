"""Public model API: ``build_model(cfg) -> Model``.

Counterpart of ``src/repro/models/model.py`` for the decoders:

    init(generator, device=)           -> params
    prefill(params, batch, n_valid=)   -> (last_logits, caches)
    decode_step(params, caches, tokens, pos) -> (logits, caches)
    prefill_chunk(params, caches, tokens, tok_pos) -> (logits, caches)
    verify_step(params, caches, tokens, pos) -> (logits, caches)
    init_caches(batch, max_len, ring_margin=, device=) -> zeroed caches
    grow_caches(caches, max_len, ring_margin=, pos=)   -> prefill caches
                                          grown for decoding

The four forward entry points take ``aux=``, a dict like
``transformer.zero_aux()``'s, into which a stack with mixture-of-experts
blocks adds their ``balance_loss`` and ``dropped_frac`` (the reference
returns them from ``forward`` only; serving drops them).

``batch`` is a dict with ``"tokens"``: (B, S) int. Parameters are a
nested dict in the reference's layout (``decoder/cycles/0_attn/...``
stacked over layers), whether float tensors or QuantizedTensor views.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

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
        unembedding adds ``lm_head`` (d_model, vocab)."""
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
        return params

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
        x = self._embed(params, tokens)
        x, caches = tfm.run_stack(cfg, params["decoder"], x, mode="prefill", pos=n_valid,
                                  aux=aux)
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
        ring_margin`` slots."""
        return tfm.stack_init_caches(self.cfg, batch, max_len, ring_margin=ring_margin,
                                     device=resolve_device(device))

    def grow_caches(self, caches, max_len: int, *, ring_margin: int = 0, pos: int = 0):
        """Pad prefill caches of full-attention blocks (``attn``,
        ``global``, ``moe``, ``shared_attn``) along the sequence axis to
        ``max_len``. With ``ring_margin`` > 0 the rings of windowed blocks
        are repacked into ``window + ring_margin`` slots
        (``grow_ring_cache``; ``pos`` = the tokens consumed so far, the
        prompt's length), so that blocks of up to ``ring_margin`` rows
        never overwrite live window entries. Recurrent states are final
        size and come back as they are."""
        cfg = self.cfg

        def pad(a: torch.Tensor) -> torch.Tensor:
            S = a.shape[-2]
            if S >= max_len:
                return a
            out = a.new_zeros(a.shape[:-2] + (max_len, a.shape[-1]))
            out[..., :S, :] = a
            return out

        def grow(kind: str, c: dict) -> dict:
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
