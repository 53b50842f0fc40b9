"""The model's entry points to the kernels.

Counterpart of ``src/repro/kernels/ops.py``. ``LAUNCH_COUNTS`` tallies
calls at the call site under the reference's names, whichever path the
call takes; each kernel module's own ``launches`` counts only the CUDA
launches. A tensor on the CPU takes the plain version, a CUDA tensor the
hand-written kernel.
"""
from __future__ import annotations

import collections

import torch

from repro_torch import obs as _obs
from repro_torch.kernels import bitplane as _bp
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import dequant_matmul as _dqm
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import verify_attention as _va

# Calls per entry point. Diagnostic only: reset freely, never read on a
# hot path.
LAUNCH_COUNTS: collections.Counter = collections.Counter()
# Calls of sharded_dequant_matmul that launched the CUDA kernels (one
# B2 launch a shard each, counted by B2's own counters); the CPU path
# does not count.
sharded_launches = 0


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def _count(name: str) -> None:
    """Tally one call: ``LAUNCH_COUNTS`` and, with telemetry on, the
    registry's ``kernel_launches_total{kernel=...}``. The port runs
    eagerly, so both count every call: equal to ``LAUNCH_COUNTS``. The
    reference counts a jitted entry point once a trace (4 decode steps
    are 1 ``decode_attention``), so the two packages' values of this
    family differ by design; its name and help text are the reference's,
    so one dashboard reads both."""
    LAUNCH_COUNTS[name] += 1
    if _obs.enabled():
        _obs.get_registry().counter(
            "kernel_launches_total",
            "Pallas kernel dispatches by entry point").inc(kernel=name)


def dequant_matmul(x, q, scale, offset, keep=None, *, bits=None, rows="any"):
    """y = x @ (scale * q + offset); scale and offset are one-element
    float32 tensors on x's device, read by the kernel where it runs, as
    is ``keep``, a truncated view's plane mask (the top ``keep`` of
    ``bits`` bits of q). ``rows="decode"`` keeps every M on the route
    whose rows do not depend on M."""
    _count("dequant_matmul")
    return _dqm.dequant_matmul(x, q, scale, offset, keep, bits=bits, rows=rows)


def sharded_dequant_matmul(x, shards, scales, offsets, *, mesh, keeps=None, bits=None,
                           rows="any"):
    """Tensor-parallel ``y = x @ (scale * q + offset)`` with q (K, N) split
    on N over ``mesh``'s model axis: ``shards[j]`` is shard j's (K, N_j)
    accumulator columns on ``mesh.model_devices[j]``, x (M, K) lies on the
    home device. Replaces ``src/repro/kernels/ops.py:76``
    ``sharded_dequant_matmul`` (B2 under ``shard_map``).

    x goes to each shard's device (no copy where it lies there already),
    one B2 launch (``kernels/dequant_matmul``, CUDA) runs on each
    shard's columns with ``n_split = N``, so that every column sums K in
    the order of the unsharded launch, and the outputs are gathered on
    x's device along N: the result is ``torch.equal`` to one B2 launch
    on the whole q. K is never split, so no partial sums are added.
    ``scales``, ``offsets`` and ``keeps`` (None: no mask) hold one
    tensor a shard, on the shard's device: the store's shard-local
    constants. Tensors on the CPU take the plain version
    (``ref.sharded_dequant_matmul_ref``); a CUDA shard launches the
    kernel or raises.

    One case gathers instead: (K, N_j) shards too narrow for the GEMV
    route's one-pass kernels (8-value loads; mixtral's router, 8 columns
    in 2 or 4) would take its general kernels, which sum K in another
    order than the one-pass launch the whole weight takes. Their columns
    (96 KB for mixtral's router) are joined on x's device and one B2
    launch runs there, on either route, so the result stays that
    launch's."""
    global sharded_launches
    _count("sharded_dequant_matmul")
    devs = mesh.model_devices
    if len(shards) != len(devs):
        raise ValueError(f"{len(shards)} shards for a mesh of {len(devs)} model shards")
    n_split = sum(q.shape[1] for q in shards)
    for j, q in enumerate(shards):
        if q.device != devs[j]:
            raise ValueError(f"shard {j} lies on {q.device}, the mesh puts it on {devs[j]}")
    if x.device.type == "cpu" and all(d.type == "cpu" for d in devs):
        return _ref.sharded_dequant_matmul_ref(x, shards, scales, offsets, keeps, bits=bits)
    if x.device.type != "cuda" or any(d.type != "cuda" for d in devs):
        raise ValueError(f"x on {x.device} and shards on {[str(d) for d in devs]}: the "
                         f"CUDA path wants every tensor on a card")
    if not all(_dqm.one_pass(q, n_split) for q in shards):
        def home(t):
            return t if t is None or t.device == x.device else t.to(x.device, non_blocking=True)
        whole = torch.cat([home(q) for q in shards], dim=1)
        if _dqm.one_pass(whole):
            sharded_launches += 1
            return _dqm.dequant_matmul(x, whole, home(scales[0]), home(offsets[0]),
                                       None if keeps is None else home(keeps[0]), bits=bits,
                                       rows=rows)
    outs = []
    for q, s, o, k, dev in zip(shards, scales, offsets,
                               [None] * len(shards) if keeps is None else keeps, devs):
        xj = x if x.device == dev else x.to(dev, non_blocking=True)
        with torch.cuda.device(dev):   # the C launchers launch on the current card
            y = _dqm.dequant_matmul(xj, q, s, o, k, bits=bits, rows=rows, n_split=n_split)
        outs.append(y if dev == x.device else y.to(x.device, non_blocking=True))
    sharded_launches += 1
    return torch.cat(outs, dim=1)


def plane_or(acc, plane, *, shift):
    _count("plane_or")
    return _bp.plane_or(acc, plane, shift=shift)


def plane_or_segments(acc, plane, shifts, *, block: int = 1024):
    _count("plane_or_segments")
    return _bp.plane_or_segments(acc, plane, shifts, block=block)


def plane_extract(q, *, bits, before, width, out_dtype=None):
    """Eq. (3) on the server side; ``out_dtype`` defaults to q's dtype, as
    the reference's kernel writes."""
    _count("plane_extract")
    return _bp.plane_extract(q, bits=bits, before=before, width=width, out_dtype=out_dtype)


def decode_attention(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """Ragged batched decode attention: q (B, H, hd); k/v in the native
    (B, Kh, S, hd) cache layout; k_pos (B, S); q_pos (B,). Returns q's
    dtype."""
    _count("decode_attention")
    return _da.flash_decode(q, k, v, k_pos, q_pos, window=window, softcap=softcap)


def flash_verify(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """Ragged attention of T query rows per slot: q (B, T, H, hd); k/v in
    the native (B, Kh, S, hd) cache layout; k_pos (B, S); q_pos (B, T)
    per-row positions (negative = masked row)."""
    _count("flash_verify")
    return _va.flash_verify(q, k, v, k_pos, q_pos, window=window, softcap=softcap)


def verify_attention(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """The model's speculative-verify attention: T = k+1 draft rows per
    slot at positions pos + t, one pass over the cache. Each row equals
    a decode step at its position, bit for bit."""
    _count("verify_attention")
    return _va.flash_verify(q, k, v, k_pos, q_pos, window=window, softcap=softcap)


def prefill_attention(q, k, v, k_pos, q_pos, *, window: int = 0, softcap: float = 0.0):
    """The model's chunked-prefill attention: a (B, chunk) block of prompt
    rows per slot, q_pos holding each slot's chunk offsets (-1 for free
    and decoding slots and past a short final chunk). The same kernel as
    :func:`verify_attention`; the two names keep the call sites apart in
    ``LAUNCH_COUNTS``."""
    _count("prefill_attention")
    return _va.flash_verify(q, k, v, k_pos, q_pos, window=window, softcap=softcap)
