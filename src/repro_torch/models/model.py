"""Public model API: ``build_model(cfg) -> Model``.

Counterpart of ``src/repro/models/model.py`` for the dense decoder:

    init(generator, device=)           -> params
    prefill(params, batch)             -> (last_logits, caches)
    decode_step(params, caches, tokens, pos) -> (logits, caches)
    init_caches(batch, max_len, device=)     -> zeroed caches
    grow_caches(caches, max_len)       -> prefill caches padded for decoding

``batch`` is a dict with ``"tokens"``: (B, S) int. Parameters are a
nested dict in the reference's layout (``decoder/cycles/0_attn/...``
stacked over layers), whether float tensors or QuantizedTensor views.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ArchConfig, apply_norm, dense, embed_lookup, norm_init
from repro_torch.models.attention import decode_pos_vector


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def init(self, generator: torch.Generator, *, device="cuda") -> dict:
        """Random parameters from ``generator`` (which must live on
        ``device``), in the reference's tree layout."""
        cfg = self.cfg
        device = resolve_device(device)
        params: dict[str, Any] = {
            "embed": 0.02 * torch.randn((cfg.vocab, cfg.d_model), generator=generator,
                                        device=device),
            "decoder": tfm.stack_init(cfg, generator, device=device),
            "final_norm": norm_init(cfg),
        }
        return params

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens).to(cfg.dtype)
        return x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype)

    def _unembed(self, params, x: torch.Tensor) -> torch.Tensor:
        """Tied unembedding: ``x @ embed.T``, a transposed view of the
        table (no copy)."""
        return dense(x.to(torch.float32), params["embed"].T, dtype=torch.float32)

    def prefill(self, params, batch):
        """Logits after the last prompt token, and the prompt's caches."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        x, caches = tfm.run_stack(cfg, params["decoder"], x, mode="prefill")
        xl = apply_norm(cfg, params["final_norm"], x[:, -1:, :])
        return self._unembed(params, xl)[:, 0, :], caches

    def decode_step(self, params, caches, tokens: torch.Tensor, pos):
        """tokens: (B, 1); pos: int (lock-stepped write position) or (B,)
        int32 per-slot positions (negative = free slot). Writes the
        step's K/V into ``caches`` in place and returns them."""
        cfg = self.cfg
        pos = decode_pos_vector(pos, tokens.shape[0], tokens.device)
        x = self._embed(params, tokens)
        x, caches = tfm.run_stack(cfg, params["decoder"], x, mode="decode",
                                  caches=caches, pos=pos)
        x = apply_norm(cfg, params["final_norm"], x)
        return self._unembed(params, x)[:, 0, :], caches

    def init_caches(self, batch: int, max_len: int, *, device="cuda"):
        return tfm.stack_init_caches(self.cfg, batch, max_len,
                                     device=resolve_device(device))

    def grow_caches(self, caches, max_len: int):
        """Pad prefill caches along the sequence axis to ``max_len``."""
        def pad(a: torch.Tensor) -> torch.Tensor:
            S = a.shape[-2]
            if S >= max_len:
                return a
            out = a.new_zeros(a.shape[:-2] + (max_len, a.shape[-1]))
            out[..., :S, :] = a
            return out

        return _map(pad, caches)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
