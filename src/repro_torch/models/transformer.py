"""Stack executor: a repeating cycle of block kinds with parameters
stacked over the cycle dimension.

Counterpart of ``src/repro/models/transformer.py`` for the ``attn``
block. The reference scans the stacked layer axis with ``lax.scan``;
here a Python loop takes layer ``r`` as a view of every stacked leaf
(``q[r]`` of a quantized leaf, with the stack's per-layer scale and
offset), so the stacked layout, and with it ``divide``'s bytes, stay the
reference's.
"""
from __future__ import annotations

import dataclasses
import torch

from repro_torch.core.plane_store import ShardedLeaf
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.models import attention as attn
from repro_torch.models.common import ArchConfig, apply_norm, dense_init, dense_rows, norm_init


def _attn_only(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is still to be ported "
                                  "(ROADMAP A8)")


def block_init(cfg: ArchConfig, generator: torch.Generator, kind: str, n: int,
               *, device="cuda"):
    """Parameters of ``n`` blocks of one kind, stacked on a leading axis."""
    _attn_only(kind)
    d, hd = cfg.d_model, cfg.hd

    def w(d_in, d_out):
        return dense_init(generator, d_in, d_out, (n,), device=device)

    return {
        "norm1": norm_init(cfg, d, (n,), device=device),
        "attn": {"wq": w(d, cfg.n_heads * hd), "wk": w(d, cfg.n_kv * hd),
                 "wv": w(d, cfg.n_kv * hd), "wo": w(cfg.n_heads * hd, d)},
        "norm2": norm_init(cfg, d, (n,), device=device),
        "mlp": {"wi_gate": w(d, cfg.d_ff), "wi_up": w(d, cfg.d_ff), "wo": w(cfg.d_ff, d)},
    }


def block_apply(cfg: ArchConfig, kind: str, p, x: torch.Tensor, *, mode: str, cache, pos):
    """Returns (x, new_cache)."""
    _attn_only(kind)
    h = apply_norm(cfg, p["norm1"], x)
    a_out, new_cache = attn.self_attention(cfg, p["attn"], h, mode=mode, cache=cache,
                                           pos=pos)
    x = x + a_out
    h2 = apply_norm(cfg, p["norm2"], x)
    x = x + attn.mlp_apply(cfg, p["mlp"], h2, rows=dense_rows(mode))
    return x, new_cache


def layer(tree, r: int):
    """Layer ``r`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: layer(v, r) for k, v in tree.items()}
    if isinstance(tree, ShardedLeaf):
        return dataclasses.replace(tree, parts=tuple(layer(p, r) for p in tree.parts))
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(
            tree, q=tree.q[r], lo=tree.lo[r], hi=tree.hi[r], scale=tree.scale[r],
            offset=tree.offset[r], received_bits=tree.received_bits[r],
            keep_bits=None if tree.keep_bits is None else tree.keep_bits[r])
    return tree[r]


def _check_layers(cfg: ArchConfig) -> None:
    if cfg.n_layers % len(cfg.cycle):
        raise NotImplementedError("a tail of blocks after the last full cycle is "
                                  "still to be ported (ROADMAP A8)")


def stack_init(cfg: ArchConfig, generator: torch.Generator, *, device="cuda") -> dict:
    """Params for the decoder stack, in the reference's layout (its
    ``tail`` is empty for every ported config)."""
    _check_layers(cfg)
    return {"cycles": {f"{j}_{kind}": block_init(cfg, generator, kind, cfg.n_cycles,
                                                 device=device)
                       for j, kind in enumerate(cfg.cycle)},
            "tail": {}}


def stack_init_caches(cfg: ArchConfig, batch: int, max_len: int, *, device="cuda"):
    """Zeroed native (B, Kh, S, hd) KV caches, stacked like the params."""
    shape = (cfg.n_cycles, batch, cfg.n_kv, max_len, cfg.hd)
    return {"cycles": {f"{j}_{kind}": {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                                       "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
                       for j, kind in enumerate(cfg.cycle)},
            "tail": {}}


def run_stack(cfg: ArchConfig, params: dict, x: torch.Tensor, *, mode: str,
              caches=None, pos=None):
    """Returns (x, caches). ``prefill`` builds the prompt's caches (stacked
    like the params); ``decode``, ``verify`` and ``prefill_chunk`` write
    into ``caches`` in place and return them."""
    _check_layers(cfg)
    per_layer: dict[str, list] = {f"{j}_{kind}": [] for j, kind in enumerate(cfg.cycle)}
    for r in range(cfg.n_cycles):
        for j, kind in enumerate(cfg.cycle):
            slot = f"{j}_{kind}"
            c = layer(caches["cycles"][slot], r) if caches is not None else None
            x, nc = block_apply(cfg, kind, layer(params["cycles"][slot], r), x,
                                mode=mode, cache=c, pos=pos)
            per_layer[slot].append(nc)
    if mode in ("decode", "verify", "prefill_chunk"):
        return x, caches
    return x, {"cycles": {slot: {name: torch.stack([c[name] for c in cs])
                                 for name in ("k", "v")}
                          for slot, cs in per_layer.items()},
               "tail": {}}
