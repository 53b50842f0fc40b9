"""Attention: RoPE, chunked online-softmax prefill attention, native
``(B, Kh, S, hd)`` KV caches and the self-attention of a decoder block.

Counterpart of ``src/repro/models/attention.py`` for the ``prefill``,
``decode``, ``verify`` and ``prefill_chunk`` modes without a window. The
caches keep the kernels' native layout from prefill on, so a decode step,
a verify block or a prefill chunk writes its tokens into the cache *in
place* (PyTorch tensors are mutable; the reference returns new arrays)
and reads the cache with ``ops.decode_attention``,
``ops.verify_attention`` or ``ops.prefill_attention`` without a
transpose or a pad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ArchConfig, activation, dense, dense_rows

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
    """Write a block of T contiguous rows of K or V into the native cache
    at each slot's own start position, in place. cache: (B, K, S, hd);
    new: (B, K, T, hd), T = 1 for a decode step; pos: (B,) int32 start
    rows, clamped into [0, S - T] as the reference's
    ``dynamic_update_slice`` clamps them. ``active`` (B,) bool keeps a
    slot's cache rows byte-identical. Returns ``cache``."""
    B, _, S, _ = cache.shape
    T = new.shape[2]
    rows = torch.arange(B, device=cache.device)[:, None]
    at = torch.clamp(pos.long(), 0, S - T)[:, None] + torch.arange(T, device=cache.device)
    val = new.transpose(1, 2).to(cache.dtype)             # (B, T, K, hd)
    if active is not None:
        val = torch.where(active[:, None, None, None], val, cache[rows, :, at])
    cache[rows, :, at] = val
    return cache


def mlp_apply(cfg: ArchConfig, p, x: torch.Tensor, *, rows: str = "any") -> torch.Tensor:
    dt = cfg.dtype
    h = activation(cfg, dense(x, p["wi_gate"], dtype=dt, rows=rows)) \
        * dense(x, p["wi_up"], dtype=dt, rows=rows)
    return dense(h, p["wo"], dtype=dt, rows=rows)


def project_qkv(cfg: ArchConfig, p, x: torch.Tensor, kv_src: torch.Tensor, *,
                rows: str = "any"):
    dt = cfg.dtype
    B, Tq, _ = x.shape
    Tk = kv_src.shape[1]
    q = dense(x, p["wq"], dtype=dt, rows=rows).reshape(B, Tq, cfg.n_heads, cfg.hd)
    k = dense(kv_src, p["wk"], dtype=dt, rows=rows).reshape(B, Tk, cfg.n_kv, cfg.hd)
    v = dense(kv_src, p["wv"], dtype=dt, rows=rows).reshape(B, Tk, cfg.n_kv, cfg.hd)
    return q, k, v


def decode_pos_vector(pos, batch: int, device) -> torch.Tensor:
    """A decode position (int, or (B,) tensor for ragged slots) as (B,) int32."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        return p.expand(batch) if p.ndim == 0 else p
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def self_attention(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str, cache, pos):
    """Full causal self-attention. ``mode`` is one of:

    * ``prefill``: returns the prompt's native caches; ``pos`` None, or
      the (B,) valid lengths of a bucket-padded prompt (one shared
      length), whose padded keys are masked;
    * ``decode``: writes one token per slot into ``cache`` in place
      (``pos`` (B,), negative = the slot writes nothing) and attends
      through ``ops.decode_attention``;
    * ``verify``: a block of T tokens per slot at ``pos[b] + t`` (a
      negative base masks the slot's every row), written as one
      contiguous block, attended through ``ops.verify_attention``;
    * ``prefill_chunk``: a (B, T) block of prompt rows whose positions
      ``pos`` (B, T) arrive precomputed (negative = masked row), written
      row by row, attended through ``ops.prefill_attention``.

    The multi-row modes write the whole block first, then attend: the
    per-row causal mask keeps rows beyond each query invisible. Masked
    rows write nothing, so their cache rows stay byte-identical.
    Sliding windows and ring caches are still to be ported (ROADMAP A8).
    Every dense layer takes ``common.dense_rows(mode)``.
    Returns (out, cache)."""
    if cfg.window:
        raise NotImplementedError("sliding-window attention and ring caches are "
                                  "still to be ported (ROADMAP A8)")
    theta = cfg.rope_theta
    B, Tq, _ = x.shape
    rows = dense_rows(mode)
    q, k, v = project_qkv(cfg, p, x, x, rows=rows)
    if mode == "prefill":
        q_pos = torch.arange(Tq, dtype=torch.int32, device=x.device)
        if pos is not None:
            # a bucket-padded prompt: positions at or after the valid
            # length become -1, keys no query sees; their cache rows lie
            # past the prompt, and decode overwrites each before any query
            # reaches it
            nv = pos.to(device=x.device, dtype=torch.int32).reshape(-1)[0]
            q_pos = torch.where(q_pos < nv, q_pos, -1)
        q = rope(q, q_pos, theta)
        k = rope(k, q_pos, theta)
        out = chunked_attention(q, k, v, q_pos, q_pos, chunk=cfg.attn_chunk)
        # one transpose at prefill; decode never transposes
        new_cache = {"k": k.transpose(1, 2).contiguous(),
                     "v": v.transpose(1, 2).contiguous()}
        return dense(out.reshape(B, Tq, -1), p["wo"], dtype=cfg.dtype), new_cache
    if mode == "decode":
        tok_pos = decode_pos_vector(pos, B, x.device)[:, None]      # (B, 1)
    elif mode == "verify":
        base = decode_pos_vector(pos, B, x.device)[:, None]
        offs = torch.arange(Tq, dtype=torch.int32, device=x.device)
        tok_pos = torch.where(base >= 0, base + offs, -1)          # (B, T)
    elif mode == "prefill_chunk":
        tok_pos = pos.to(device=x.device, dtype=torch.int32)       # (B, T)
    else:
        raise ValueError(f"unknown attention mode {mode!r}")
    q = rope(q, tok_pos, theta)
    k = rope(k, tok_pos, theta)
    kn, vn = k.transpose(1, 2), v.transpose(1, 2)                  # (B, K, T, hd)
    if mode == "prefill_chunk":
        # row by row: a T-wide block write of a short final chunk would
        # clamp near the cache end and drag its padding onto prompt rows
        for t in range(Tq):
            live = tok_pos[:, t] >= 0
            write_kv_slot(cache["k"], kn[:, :, t:t + 1], tok_pos[:, t], live)
            write_kv_slot(cache["v"], vn[:, :, t:t + 1], tok_pos[:, t], live)
    else:
        # decode and verify: one contiguous block per slot
        live = tok_pos[:, 0] >= 0
        write_kv_slot(cache["k"], kn, tok_pos[:, 0], live)
        write_kv_slot(cache["v"], vn, tok_pos[:, 0], live)
    S = cache["k"].shape[2]
    # the kernels mask k_pos > q_pos per row, so stale entries beyond each
    # row's position never contribute
    k_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    if mode == "decode":
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], k_pos,
                                   tok_pos[:, 0])[:, None]          # (B, 1, H, hd)
    else:
        attend = ops.verify_attention if mode == "verify" else ops.prefill_attention
        out = attend(q, cache["k"], cache["v"], k_pos, tok_pos)    # (B, T, H, hd)
    return dense(out.reshape(B, Tq, -1), p["wo"], dtype=cfg.dtype, rows=rows), cache
