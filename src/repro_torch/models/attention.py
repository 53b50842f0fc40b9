"""Attention: RoPE, chunked online-softmax prefill attention, native
``(B, Kh, S, hd)`` KV caches, sliding-window ring caches, the
self-attention of a decoder block and the cross-attention of an
encoder-decoder or vision block.

Counterpart of ``src/repro/models/attention.py`` for the ``full``
(training), ``prefill``, ``decode``, ``verify`` and ``prefill_chunk``
modes, with or without a window. The caches keep the kernels' native
layout from prefill on, so a decode step, a verify block or a prefill
chunk writes its tokens into the cache *in place* (PyTorch tensors are
mutable; the reference returns new arrays) and reads the cache with
``ops.decode_attention``, ``ops.verify_attention`` or
``ops.prefill_attention`` without a transpose or a pad.

A sliding-window block keeps a ring: position p lives in slot
``p % ring``, and the kernels get each slot's position from
:func:`ring_positions` (``k_pos``, negative for a slot not yet written)
with the window mask ``k_pos > q_pos - window``, so the ring's size
(``window`` plus a margin for multi-row writes) never changes what a
query sees.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool = True,
                      window: int = 0, chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks, never a (Tq, Tk) score
    matrix per head beyond one chunk. q: (B, Tq, H, hd); k/v: (B, Tk, K,
    hd); q_pos (Tq,), k_pos (Tk,) int32 (negative = invalid key).
    ``causal`` masks keys past ``q_pos`` (an encoder's and a cross
    attention's queries see every valid key); ``window`` > 0 also masks
    keys at or before ``q_pos - window``."""
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
        valid = (pp[None, :] >= 0).expand(Tq, -1)
        if causal:
            valid = valid & (pp[None, :] <= q_pos[:, None])
        if window:
            valid = valid & (pp[None, :] > q_pos[:, None] - window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vv)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]      # (B, K, G, Tq, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, hd).to(q.dtype)


def make_ring_cache(k: torch.Tensor, v: torch.Tensor, window: int):
    """Prefill keys and values (B, S, K, hd) as a ring of ``window`` slots
    in the native (B, K, window, hd) layout, holding the last
    ``min(window, S)`` positions, position p at slot ``p % window``.
    Speculation and chunked prefill widen the ring afterwards
    (:func:`grow_ring_cache`)."""
    B, S, K, hd = k.shape
    W = min(window, S)
    slots = torch.arange(S - W, S, device=k.device) % window
    rings = []
    for a in (k, v):
        ring = a.new_zeros((B, K, window, hd))
        ring[:, :, slots] = a.transpose(1, 2)[:, :, S - W:]
        rings.append(ring)
    return rings[0], rings[1]


def grow_ring_cache(cache: dict, new_size: int, pos: int) -> dict:
    """Repack a ring cache (its ring size the slot axis, -2, stacked or
    not) into a ring of ``new_size`` slots, every stored position kept
    and moved to slot ``p % new_size``; ``pos`` is the next write position
    (the tokens consumed so far), a host int. A ring of W slots is safe
    only while positions are written in strict order; a verify block or a
    prefill chunk writes T rows ahead (and a verify may rewind), so those
    paths need ``window + T`` slots. The window mask stays ``window``
    positions: only the layout widens."""
    R = cache["k"].shape[-2]
    if new_size <= R:
        return cache
    held = ring_positions(R, torch.tensor(pos - 1))     # all negative before a write
    src = torch.nonzero(held >= 0)[:, 0]
    dst = (held[src] % new_size).long()

    def regrow(a: torch.Tensor) -> torch.Tensor:
        out = a.new_zeros(a.shape[:-2] + (new_size,) + a.shape[-1:])
        out[..., dst.to(a.device), :] = a[..., src.to(a.device), :]
        return out

    return {"k": regrow(cache["k"]), "v": regrow(cache["v"])}


def ring_positions(ring: int, pos: torch.Tensor) -> torch.Tensor:
    """The position each ring slot holds after a write at ``pos``:
    ``pos - ((pos - i) % ring)`` for slot i, negative for a slot not yet
    written (and everywhere for ``pos < 0``). ``pos`` () gives (ring,),
    (B,) gives (B, ring) int32."""
    p = pos.to(torch.int32)[..., None]
    i = torch.arange(ring, dtype=torch.int32, device=pos.device)
    return p - torch.remainder(p - i, ring)


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


def qk_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """RMSNorm of each head's vector (eps 1e-6) on a float32 copy with
    the float32 scale, rounded once to x's dtype, as the reference's
    ``_qk_norm``. One ``F.rms_norm`` launch, whose rows do not depend on
    how many share it (see ``common.apply_norm``), so a verify row's q and
    k equal its decode step's."""
    return F.rms_norm(x.to(torch.float32), x.shape[-1:], weight=scale,
                      eps=1e-6).to(x.dtype)


def project_qkv(cfg: ArchConfig, p, x: torch.Tensor, kv_src: torch.Tensor, *,
                rows: str = "any"):
    dt = cfg.dtype
    B, Tq, _ = x.shape
    Tk = kv_src.shape[1]
    q = dense(x, p["wq"], dtype=dt, rows=rows).reshape(B, Tq, cfg.n_heads, cfg.hd)
    k = dense(kv_src, p["wk"], dtype=dt, rows=rows).reshape(B, Tk, cfg.n_kv, cfg.hd)
    v = dense(kv_src, p["wv"], dtype=dt, rows=rows).reshape(B, Tk, cfg.n_kv, cfg.hd)
    if cfg.qk_norm:
        q = qk_norm(q, p["q_norm"])
        k = qk_norm(k, p["k_norm"])
    return q, k, v


def decode_pos_vector(pos, batch: int, device) -> torch.Tensor:
    """A decode position (int, or (B,) tensor for ragged slots) as (B,) int32."""
    if isinstance(pos, torch.Tensor):
        p = pos.to(device=device, dtype=torch.int32)
        return p.expand(batch) if p.ndim == 0 else p
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def self_attention(cfg: ArchConfig, p, x: torch.Tensor, *, mode: str, cache, pos,
                   window: int = 0, rope_theta: float | None = None):
    """Causal self-attention, over the whole past or, with ``window`` > 0,
    over the last ``window`` positions held in a ring cache. ``mode`` is
    one of:

    * ``full``: the prefill's attention over the whole sequence without a
      cache (training and ``Model.forward``); returns (out, None);
    * ``prefill``: returns the prompt's native caches (a ring of
      ``window`` slots with a window); ``pos`` None, or the (B,) valid
      lengths of a bucket-padded prompt (one shared length), whose padded
      keys are masked; a ring has no masked slots, so a windowed block
      refuses padding;
    * ``decode``: writes one token per slot into ``cache`` in place
      (``pos`` (B,), negative = the slot writes nothing), at slot
      ``pos % ring`` over a ring, and attends through
      ``ops.decode_attention``;
    * ``verify``: a block of T tokens per slot at ``pos[b] + t`` (a
      negative base masks the slot's every row), attended through
      ``ops.verify_attention``;
    * ``prefill_chunk``: a (B, T) block of prompt rows whose positions
      ``pos`` (B, T) arrive precomputed (negative = masked row), written
      row by row, attended through ``ops.prefill_attention``.

    The multi-row modes write the whole block first, then attend: the
    per-row causal mask keeps rows beyond each query invisible. Masked
    rows write nothing, so their cache rows stay byte-identical. Over a
    ring they write row by row at ``(pos + t) % ring`` (a block would wrap
    past the ring's end) and need ``ring >= window + T``, or the block
    would overwrite positions still inside an earlier row's window.
    ``rope_theta`` defaults to ``cfg.rope_theta``. Every dense layer
    takes ``common.dense_rows(mode)``. Returns (out, cache)."""
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    B, Tq, _ = x.shape
    rows = dense_rows(mode)
    q, k, v = project_qkv(cfg, p, x, x, rows=rows)
    if mode in ("full", "prefill"):
        q_pos = torch.arange(Tq, dtype=torch.int32, device=x.device)
        if pos is not None:
            # a bucket-padded prompt: positions at or after the valid
            # length become -1, keys no query sees; their cache rows lie
            # past the prompt, and decode overwrites each before any query
            # reaches it
            if window:
                raise NotImplementedError(
                    "bucketed prefill is not supported for sliding-window attention "
                    "(the ring layout has no masked slots)")
            nv = pos.to(device=x.device, dtype=torch.int32).reshape(-1)[0]
            q_pos = torch.where(q_pos < nv, q_pos, -1)
        q = rope(q, q_pos, theta)
        k = rope(k, q_pos, theta)
        out = chunked_attention(q, k, v, q_pos, q_pos, window=window, chunk=cfg.attn_chunk)
        out = dense(out.reshape(B, Tq, -1), p["wo"], dtype=cfg.dtype)
        if mode == "full":
            return out, None
        if window:
            rk, rv = make_ring_cache(k, v, window)
            new_cache = {"k": rk, "v": rv}
        else:
            # one transpose at prefill; decode never transposes
            new_cache = {"k": k.transpose(1, 2).contiguous(),
                         "v": v.transpose(1, 2).contiguous()}
        return out, new_cache
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
    S = cache["k"].shape[2]
    if window and mode != "decode" and S < window + Tq:
        raise ValueError(
            f"multi-row writes over a ring cache need ring >= window + T ({window} + "
            f"{Tq}), got {S}: the block would clobber live window entries (grow the "
            f"cache with ring_margin >= the block length)")
    if mode == "prefill_chunk" or (window and mode == "verify"):
        # row by row, each at slot pos % S: over a ring a block would wrap
        # past its end, and a T-wide block write of a short final chunk
        # would clamp near the cache end and drag its padding onto prompt rows
        for t in range(Tq):
            live = tok_pos[:, t] >= 0
            at = torch.remainder(tok_pos[:, t], S)
            write_kv_slot(cache["k"], kn[:, :, t:t + 1], at, live)
            write_kv_slot(cache["v"], vn[:, :, t:t + 1], at, live)
    else:
        # decode, and verify over a full cache: one contiguous block per slot
        live = tok_pos[:, 0] >= 0
        at = torch.remainder(tok_pos[:, 0], S) if window else tok_pos[:, 0]
        write_kv_slot(cache["k"], kn, at, live)
        write_kv_slot(cache["v"], vn, at, live)
    if window:
        # the ring's last written position per slot (-1 for a fully masked
        # slot, whose every k_pos is negative)
        k_pos = ring_positions(S, tok_pos.amax(dim=1))
    else:
        # the kernels mask k_pos > q_pos per row, so stale entries beyond
        # each row's position never contribute
        k_pos = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    if mode == "decode":
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], k_pos, tok_pos[:, 0],
                                   window=window)[:, None]          # (B, 1, H, hd)
    else:
        attend = ops.verify_attention if mode == "verify" else ops.prefill_attention
        out = attend(q, cache["k"], cache["v"], k_pos, tok_pos,
                     window=window)                                # (B, T, H, hd)
    return dense(out.reshape(B, Tq, -1), p["wo"], dtype=cfg.dtype, rows=rows), cache


def cross_attention(cfg: ArchConfig, p, x: torch.Tensor, enc_kv: dict, *, native: bool,
                    rows: str = "any", positions: dict | None = None) -> torch.Tensor:
    """Attention of ``x`` over a memory computed once at prefill (the
    encoder's output, or the projected image embeddings) and static
    afterwards. ``native=False`` (a prefill): ``enc_kv`` is (B, Tv, Kh,
    hd) from :func:`cross_kv` and attention runs chunked, every query
    seeing every memory slot. ``native=True`` (a decode step, Tq = 1, or a
    verify block): ``enc_kv`` is the cached native (B, Kh, Tv, hd) layout,
    read through ``ops.decode_attention`` or ``ops.verify_attention`` with
    ``k_pos = arange(Tv)`` and every row at ``q_pos = Tv``, so that the
    causal mask admits every slot and no step transposes the cache.
    ``rows`` is the dense layers' (``common.dense_rows``); ``positions``,
    a dict shared by the layers of one step, keeps those positions by
    (Tv, Tq), so that a step builds them once, not once a layer. No rope:
    memory positions are not the decoder's."""
    dt = cfg.dtype
    B, Tq, _ = x.shape
    q = dense(x, p["wq"], dtype=dt, rows=rows).reshape(B, Tq, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = qk_norm(q, p["q_norm"])
    if native:
        Tv = enc_kv["k"].shape[2]
        positions = {} if positions is None else positions
        if (Tv, Tq) not in positions:
            positions[Tv, Tq] = (
                torch.arange(Tv, dtype=torch.int32, device=x.device).expand(B, Tv),
                torch.full((B,) if Tq == 1 else (B, Tq), Tv, dtype=torch.int32,
                           device=x.device))
        k_pos, q_pos = positions[Tv, Tq]
        if Tq == 1:
            out = ops.decode_attention(q[:, 0], enc_kv["k"], enc_kv["v"], k_pos,
                                       q_pos)[:, None]
        else:
            out = ops.verify_attention(q, enc_kv["k"], enc_kv["v"], k_pos, q_pos)
    else:
        Tv = enc_kv["k"].shape[1]
        out = chunked_attention(
            q, enc_kv["k"], enc_kv["v"], torch.zeros((Tq,), dtype=torch.int32, device=x.device),
            torch.arange(Tv, dtype=torch.int32, device=x.device), causal=False,
            chunk=cfg.attn_chunk)
    return dense(out.reshape(B, Tq, -1), p["wo"], dtype=dt, rows=rows)


def cross_kv(cfg: ArchConfig, p, enc_out: torch.Tensor) -> dict:
    """A block's keys and values of the memory ``enc_out`` (B, Tv, d),
    projected once at prefill: (B, Tv, Kh, hd), ``k_norm`` applied with
    ``qk_norm``. :func:`to_native_kv` makes the cache of them."""
    dt = cfg.dtype
    B, Tv, _ = enc_out.shape
    k = dense(enc_out, p["wk"], dtype=dt).reshape(B, Tv, cfg.n_kv, cfg.hd)
    v = dense(enc_out, p["wv"], dtype=dt).reshape(B, Tv, cfg.n_kv, cfg.hd)
    if cfg.qk_norm:
        k = qk_norm(k, p["k_norm"])
    return {"k": k, "v": v}


def to_native_kv(kv: dict) -> dict:
    """(B, Tv, Kh, hd) -> the native (B, Kh, Tv, hd) cache, one transpose
    at prefill, so that decode steps read the cache as it is."""
    return {"k": kv["k"].transpose(1, 2).contiguous(),
            "v": kv["v"].transpose(1, 2).contiguous()}
