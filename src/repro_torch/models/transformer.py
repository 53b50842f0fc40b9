"""Stack executor: a repeating cycle of block kinds with parameters
stacked over the cycle dimension.

Counterpart of ``src/repro/models/transformer.py`` for the attention
blocks ``attn``, ``swa`` and ``global``, the mixture-of-experts blocks
``moe`` and ``swa_moe``, and for a tail of blocks after the last full
cycle (unstacked, as the reference keeps them). The
reference scans the stacked layer axis with ``lax.scan``; here a Python
loop takes layer ``r`` as a view of every stacked leaf (``q[r]`` of a
quantized leaf, with the stack's per-layer scale and offset), so the
stacked layout, and with it ``divide``'s bytes, stay the reference's.
"""
from __future__ import annotations

import dataclasses
import torch

from repro_torch.core.plane_store import ShardedLeaf, leaf_to
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ArchConfig, apply_norm, dense_init, dense_rows, norm_init


ATTN_KINDS = ("attn", "swa", "global", "moe", "swa_moe")
MOE_KINDS = ("moe", "swa_moe")


def zero_aux(device=None) -> dict:
    """Zeroed MoE auxiliaries (float32 scalars): the dict that
    ``run_stack(aux=)`` adds each MoE block's into."""
    return {"balance_loss": torch.zeros((), device=device),
            "dropped_frac": torch.zeros((), device=device)}


def _attn_only(kind: str) -> None:
    if kind not in ATTN_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is still to be ported "
                                  "(ROADMAP A8)")


def attn_window(cfg: ArchConfig, kind: str) -> int:
    """The attention window of a block kind: ``swa`` and ``swa_moe``
    attend over the last ``cfg.window`` positions, the others over the
    whole past."""
    return cfg.window if kind in ("swa", "swa_moe") else 0


def attn_theta(cfg: ArchConfig, kind: str) -> float:
    """The rope base of a block kind: gemma3's ``global`` layers take 100x
    ``cfg.rope_theta``."""
    return cfg.rope_theta * 100.0 if kind == "global" else cfg.rope_theta


def block_init(cfg: ArchConfig, generator: torch.Generator, kind: str, lead: tuple = (),
               *, device="cuda"):
    """Parameters of a block of one kind; ``lead`` stacks them (``(n,)``
    for a cycle slot's ``n`` layers, ``()`` for a tail block). With
    ``qk_norm`` the attention holds ``q_norm``/``k_norm`` scales (hd,)."""
    _attn_only(kind)
    d, hd = cfg.d_model, cfg.hd

    def w(d_in, d_out):
        return dense_init(generator, d_in, d_out, lead, device=device)

    attn_p = {"wq": w(d, cfg.n_heads * hd), "wk": w(d, cfg.n_kv * hd),
              "wv": w(d, cfg.n_kv * hd), "wo": w(cfg.n_heads * hd, d)}
    if cfg.qk_norm:
        attn_p["q_norm"] = torch.ones(lead + (hd,), device=device)
        attn_p["k_norm"] = torch.ones(lead + (hd,), device=device)
    if kind in MOE_KINDS:
        ffn = {"moe": moe_mod.moe_init(cfg, generator, lead, device=device)}
    else:
        ffn = {"mlp": {"wi_gate": w(d, cfg.d_ff), "wi_up": w(d, cfg.d_ff),
                       "wo": w(cfg.d_ff, d)}}
    return {"norm1": norm_init(cfg, d, lead, device=device), "attn": attn_p,
            "norm2": norm_init(cfg, d, lead, device=device), **ffn}


def block_apply(cfg: ArchConfig, kind: str, p, x: torch.Tensor, *, mode: str, cache, pos,
                with_aux: bool = False):
    """Returns (x, new_cache, aux); ``aux`` is None for a block without
    experts, and unless ``with_aux`` asks for a MoE block's."""
    _attn_only(kind)
    h = apply_norm(cfg, p["norm1"], x)
    a_out, new_cache = attn.self_attention(cfg, p["attn"], h, mode=mode, cache=cache,
                                           pos=pos, window=attn_window(cfg, kind),
                                           rope_theta=attn_theta(cfg, kind))
    x = x + a_out
    h2 = apply_norm(cfg, p["norm2"], x)
    if kind in MOE_KINDS:
        m_out, aux = moe_mod.moe_apply(cfg, p["moe"], h2, rows=dense_rows(mode),
                                       with_aux=with_aux)
        return x + m_out, new_cache, aux
    x = x + attn.mlp_apply(cfg, p["mlp"], h2, rows=dense_rows(mode))
    return x, new_cache, None


def layer(tree, r: int):
    """Layer ``r`` of a stacked tree: views, no copies."""
    if isinstance(tree, dict):
        return {k: layer(v, r) for k, v in tree.items()}
    if isinstance(tree, ShardedLeaf):
        if tree.axis == -len(tree.shape):
            # split on the layer axis itself (a bank sliced by layer, when
            # the depth equals n_experts): layer r is one part's, moved home
            for part, n in zip(tree.parts, tree.sizes()):
                if r < n:
                    return leaf_to(layer(part, r), tree.mesh.home)
                r -= n
        return dataclasses.replace(tree, parts=tuple(layer(p, r) for p in tree.parts))
    if isinstance(tree, QuantizedTensor):
        return dataclasses.replace(
            tree, q=tree.q[r], lo=tree.lo[r], hi=tree.hi[r], scale=tree.scale[r],
            offset=tree.offset[r], received_bits=tree.received_bits[r],
            keep_bits=None if tree.keep_bits is None else tree.keep_bits[r])
    return tree[r]


def stack_init(cfg: ArchConfig, generator: torch.Generator, *, device="cuda") -> dict:
    """Params for the decoder stack in the reference's layout: each cycle
    slot's blocks stacked over the ``n_cycles`` layers, then the tail's
    blocks after the last full cycle, one each."""
    for kind in cfg.cycle:
        _attn_only(kind)
    return {"cycles": {f"{j}_{kind}": block_init(cfg, generator, kind, (cfg.n_cycles,),
                                                 device=device)
                       for j, kind in enumerate(cfg.cycle)},
            "tail": {f"{i}_{kind}": block_init(cfg, generator, kind, device=device)
                     for i, kind in enumerate(cfg.tail)}}


def _cache_len(cfg: ArchConfig, kind: str, max_len: int, ring_margin: int) -> int:
    """A block's cache rows: a ring of ``window + ring_margin`` slots for a
    windowed kind, ``max_len`` rows otherwise."""
    return cfg.window + ring_margin if attn_window(cfg, kind) else max_len


def stack_init_caches(cfg: ArchConfig, batch: int, max_len: int, *, ring_margin: int = 0,
                      device="cuda"):
    """Zeroed native (B, Kh, S, hd) KV caches, stacked like the params;
    ``ring_margin`` widens the rings of windowed blocks beyond the window
    for multi-row writes (verify blocks, prefill chunks)."""
    def zeros(kind: str, lead: tuple) -> dict:
        _attn_only(kind)
        shape = lead + (batch, cfg.n_kv, _cache_len(cfg, kind, max_len, ring_margin), cfg.hd)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    return {"cycles": {f"{j}_{kind}": zeros(kind, (cfg.n_cycles,))
                       for j, kind in enumerate(cfg.cycle)},
            "tail": {f"{i}_{kind}": zeros(kind, ()) for i, kind in enumerate(cfg.tail)}}


def run_stack(cfg: ArchConfig, params: dict, x: torch.Tensor, *, mode: str,
              caches=None, pos=None, aux: dict | None = None):
    """Returns (x, caches). ``prefill`` builds the prompt's caches (stacked
    like the params); ``decode``, ``verify`` and ``prefill_chunk`` write
    into ``caches`` in place and return them. The cycles run first, layer
    by layer, then the tail. ``aux``, a dict like :func:`zero_aux`'s,
    takes the sum over the MoE blocks of their ``balance_loss`` and
    ``dropped_frac``, as the reference's ``run_stack`` returns them."""
    def add(a):
        if a is not None:
            for k in aux:
                aux[k] = aux[k] + a[k]

    per_layer: dict[str, list] = {f"{j}_{kind}": [] for j, kind in enumerate(cfg.cycle)}
    for r in range(cfg.n_cycles):
        for j, kind in enumerate(cfg.cycle):
            slot = f"{j}_{kind}"
            c = layer(caches["cycles"][slot], r) if caches is not None else None
            x, nc, a = block_apply(cfg, kind, layer(params["cycles"][slot], r), x,
                                   mode=mode, cache=c, pos=pos, with_aux=aux is not None)
            per_layer[slot].append(nc)
            add(a)
    tail = {}
    for i, kind in enumerate(cfg.tail):
        slot = f"{i}_{kind}"
        c = caches["tail"][slot] if caches is not None else None
        x, tail[slot], a = block_apply(cfg, kind, params["tail"][slot], x, mode=mode,
                                       cache=c, pos=pos, with_aux=aux is not None)
        add(a)
    if mode in ("decode", "verify", "prefill_chunk"):
        return x, caches
    return x, {"cycles": {slot: {name: torch.stack([c[name] for c in cs])
                                 for name in ("k", "v")}
                          for slot, cs in per_layer.items()},
               "tail": tail}
