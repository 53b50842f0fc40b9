"""Attention: RoPE, chunked online-softmax prefill attention, native
``(B, Kh, S, hd)`` KV caches and the self-attention of a decoder block.

Counterpart of ``src/repro/models/attention.py`` for the ``prefill`` and
``decode`` modes. The caches keep the decode kernel's native layout from
prefill on, so a decode step writes one token per slot into its cache
*in place* (PyTorch tensors are mutable; the reference returns new
arrays) and reads the cache with ``ops.decode_attention`` without a
transpose or a pad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ArchConfig, activation, dense

NEG_INF = -1e30


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); pos: (T,) shared or (B, T) per-slot positions."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = pos.to(torch.float32)[..., None] * freqs   # (..., T, half)
    if angles.ndim == 2:
        angles = angles[None]                          # (1|B, T, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *, chunk: int = 1024
                      ) -> torch.Tensor:
    """Causal online-softmax attention over KV chunks, never a (Tq, Tk)
    score matrix per head beyond one chunk. q: (B, Tq, H, hd); k/v: (B,
    Tk, K, hd); q_pos (Tq,), k_pos (Tk,) int32 (negative = invalid key)."""
    B, Tq, H, hd = q.shape
    Tk, K = k.shape[1], k.shape[2]
    G = H // K
    chunk = min(chunk, Tk) if Tk else 1
    pad = (-Tk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = torch.nn.functional.pad(k_pos, (0, pad), value=-1)
    qg = q.reshape(B, Tq, K, G, hd).to(torch.float32) * (hd ** -0.5)
    m = torch.full((B, K, G, Tq), NEG_INF, device=q.device)
    l = torch.zeros((B, K, G, Tq), device=q.device)
    acc = torch.zeros((B, K, G, Tq, hd), device=q.device)
    for c0 in range(0, k.shape[1], chunk):
        kk = k[:, c0:c0 + chunk].to(torch.float32)
        vv = v[:, c0:c0 + chunk].to(torch.float32)
        pp = k_pos[c0:c0 + chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kk)
        valid = (pp[None, :] >= 0) & (pp[None, :] <= q_pos[:, None])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vv)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]      # (B, K, G, Tq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd).to(q.dtype)


def write_kv_slot(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                  active: torch.Tensor | None = None) -> torch.Tensor:
    """Write a token's K or V into the native cache at each slot's own
    position, in place. cache: (B, K, S, hd); new: (B, K, 1, hd); pos:
    (B,) int32, already clamped into range. ``active`` (B,) bool keeps a
    slot's cache row as it was. Returns ``cache``."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    val = new[:, :, 0].to(cache.dtype)                    # (B, K, hd)
    if active is not None:
        val = torch.where(active[:, None, None], val, cache[rows, :, pos])
    cache[rows, :, pos] = val
    return cache


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.dtype
    h = activation(cfg, dense(x, p["wi_gate"], dtype=dt)) * dense(x, p["wi_up"], dtype=dt)
    return dense(h, p["wo"], dtype=dt)


def project_qkv(cfg: ArchConfig, p, x: torch.Tensor, kv_src: torch.Tensor):
    dt = cfg.dtype
    B, Tq, _ = x.shape
    Tk = kv_src.shape[1]
    q = dense(x, p["wq"], dtype=dt).reshape(B, Tq, cfg.n_heads, cfg.hd)
    k = dense(kv_src, p["wk"], dtype=dt).reshape(B, Tk, cfg.n_kv, cfg.hd)
    v = dense(kv_src, p["wv"], dtype=dt).reshape(B, Tk, cfg.n_kv, cfg.hd)
    return q, k, v


def decode_pos_vector(pos, batch: int, device) -> torch.Tensor:
    """A decode position (int, or (B,) tensor for ragged slots) as (B,) int32."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        return p.expand(batch) if p.ndim == 0 else p
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def self_attention(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str, cache, pos):
    """Full causal self-attention (sliding windows and ring caches are
    still to be ported, ROADMAP A5). ``mode`` is ``prefill`` (returns
    the prompt's native caches) or ``decode`` (writes one token per slot
    into ``cache`` in place and attends through
    ``ops.decode_attention``). Returns (out, cache)."""
    theta = cfg.rope_theta
    B, Tq, _ = x.shape
    q, k, v = project_qkv(cfg, p, x, x)
    if mode == "prefill":
        q_pos = torch.arange(Tq, dtype=torch.int32, device=x.device)
        q = rope(q, q_pos, theta)
        k = rope(k, q_pos, theta)
        out = chunked_attention(q, k, v, q_pos, q_pos, chunk=cfg.attn_chunk)
        # one transpose at prefill; decode never transposes
        new_cache = {"k": k.transpose(1, 2).contiguous(),
                     "v": v.transpose(1, 2).contiguous()}
    elif mode == "decode":
        pos_vec = decode_pos_vector(pos, B, x.device)       # (B,)
        q = rope(q, pos_vec[:, None], theta)
        k = rope(k, pos_vec[:, None], theta)
        # inactive slots (pos < 0) write nothing
        live = pos_vec >= 0
        at = torch.clamp(pos_vec, min=0)
        write_kv_slot(cache["k"], k.transpose(1, 2), at, live)
        write_kv_slot(cache["v"], v.transpose(1, 2), at, live)
        S = cache["k"].shape[2]
        # the kernel masks k_pos > q_pos per slot, so stale entries beyond
        # each slot's position never contribute
        k_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], k_pos,
                                   pos_vec)[:, None]        # (B, 1, H, hd)
        new_cache = cache
    else:
        raise NotImplementedError(f"attention mode {mode!r} is still to be ported "
                                  "(ROADMAP A9/A10)")
    return dense(out.reshape(B, Tq, -1), p["wo"], dtype=cfg.dtype), new_cache
