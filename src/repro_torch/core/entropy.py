"""Byte-aligned entropy codec for bit-plane payloads (wire v2).

High planes of affine-quantized weights are heavily skewed: floor
quantization (eq. 2) maps a roughly centered weight distribution into
the middle of ``[0, 2^bits)``, so the MSB plane is mostly one value and
near-MSB planes carry far less than ``width`` bits of real entropy per
element. The v2 wire exploits that with a per-plane choice between
three byte-aligned encodings of the *packed* plane bytes
(:func:`repro.core.bitplanes.pack_bits` output):

* ``MODE_RAW``  — the packed bytes verbatim;
* ``MODE_RLE``  — PackBits-style run-length coding (control byte:
  ``c < 128`` copies ``c+1`` literals, ``c >= 128`` repeats the next
  byte ``c - 126`` times) — wins on long constant runs;
* ``MODE_RANS`` — order-0 static rANS over bytes (12-bit
  probabilities, 16-bit renormalization, lane-interleaved so encode
  and decode are numpy-vectorized across lanes) — wins on skewed but
  run-free planes.

:func:`encode` measures all candidates and returns the smallest, so a
coded body is NEVER larger than the raw packed plane; the 2-byte
per-unit frame the wire adds on top is the total worst-case overhead.
Everything here is host-side numpy — the decoded bytes feed the
existing ``plane_or_segments`` ingest unchanged, and reconstruction is
bit-exact (pinned by property tests).
"""
from __future__ import annotations

import struct

import numpy as np

MODE_RAW = 0
MODE_RLE = 1
MODE_RANS = 2
MODES = (MODE_RAW, MODE_RLE, MODE_RANS)

# rANS parameters: 12-bit quantized probabilities, uint64 lane states
# kept in [2^16, 2^32) with 16-bit renormalization. With these bounds
# each symbol emits/reads exactly 0 or 1 u16 per step (see _rans_*).
PROB_BITS = 12
_M = 1 << PROB_BITS
_STATE_LO = 1 << 16
_MAX_LANES = 255  # lane count is a single header byte


# ---------------------------------------------------------------------------
# PackBits-style RLE
# ---------------------------------------------------------------------------

def _byte_runs(data: np.ndarray):
    """(starts, lengths) of maximal constant runs."""
    change = np.flatnonzero(data[1:] != data[:-1]) + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [data.size]))
    return starts, ends - starts


def _rle_encode(data: np.ndarray) -> bytes | None:
    """PackBits-style encode; None when clearly not worth attempting
    (run structure too fine — the Python sweep over runs would cost
    more than the bytes it could save)."""
    n = data.size
    if n == 0:
        return None
    starts, lengths = _byte_runs(data)
    if starts.size > max(64, n // 3):
        return None
    out = bytearray()
    lit_start = None  # start of the pending literal block

    def flush_literals(upto: int) -> None:
        nonlocal lit_start
        if lit_start is None:
            return
        pos = lit_start
        while pos < upto:
            c = min(128, upto - pos)
            out.append(c - 1)
            out.extend(data[pos:pos + c].tobytes())
            pos += c
        lit_start = None

    for s, ln in zip(starts.tolist(), lengths.tolist()):
        if ln >= 3:
            flush_literals(s)
            val = int(data[s])
            rem = ln
            while rem >= 2:
                c = min(129, rem)
                out.append(128 + c - 2)
                out.append(val)
                rem -= c
            if rem:  # 1-byte tail of a long run joins the next literals
                lit_start = s + ln - 1
        else:
            if lit_start is None:
                lit_start = s
    flush_literals(n)
    return bytes(out)


def _rle_decode(body: bytes, n_bytes: int) -> bytes:
    data = np.frombuffer(body, np.uint8)
    out = np.empty(n_bytes, np.uint8)
    i = pos = 0
    while pos < n_bytes:
        if i >= data.size:
            raise ValueError("RLE body truncated")
        c = int(data[i])
        i += 1
        if c < 128:
            ln = c + 1
            if i + ln > data.size or pos + ln > n_bytes:
                raise ValueError("RLE literal overruns payload")
            out[pos:pos + ln] = data[i:i + ln]
            i += ln
        else:
            ln = c - 126
            if i >= data.size or pos + ln > n_bytes:
                raise ValueError("RLE run overruns payload")
            out[pos:pos + ln] = data[i]
            i += 1
        pos += ln
    if i != data.size:
        raise ValueError("trailing bytes after RLE payload")
    return out.tobytes()


# ---------------------------------------------------------------------------
# order-0 static rANS, lane-interleaved
# ---------------------------------------------------------------------------

def _normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale byte counts to a (256,) table summing to exactly ``_M``,
    every present symbol >= 1."""
    total = int(counts.sum())
    present = np.flatnonzero(counts)
    f = np.maximum(
        1, (counts[present].astype(np.float64) * _M / total)
        .astype(np.int64))
    diff = _M - int(f.sum())
    while diff != 0:
        if diff > 0:
            f[int(np.argmax(f))] += diff
            diff = 0
        else:
            i = int(np.argmax(f))
            take = min(-diff, int(f[i]) - 1)
            if take == 0:
                raise AssertionError("cannot normalize frequency table")
            f[i] -= take
            diff += take
    freqs = np.zeros(256, np.int64)
    freqs[present] = f
    return freqs


def _n_lanes(n: int) -> int:
    return int(np.clip(n // 4096, 1, _MAX_LANES))


def _rans_overhead(n_sym: int, n_lanes: int) -> int:
    return 3 + 3 * n_sym + 8 * n_lanes


def _rans_encode(data: np.ndarray) -> bytes | None:
    n = data.size
    if n == 0:
        return None
    counts = np.bincount(data, minlength=256).astype(np.int64)
    freqs = _normalize_freqs(counts)
    cum = np.zeros(256, np.int64)
    cum[1:] = np.cumsum(freqs)[:-1]
    L = _n_lanes(n)
    f_all = freqs[data].astype(np.uint64)
    c_all = cum[data].astype(np.uint64)
    per_lane = np.array([(n - j + L - 1) // L for j in range(L)])
    T = int(per_lane.max())
    # (T, L) symbol matrices in REVERSE order per lane (rANS encodes
    # back-to-front so the decoder reads front-to-back); lane j owns
    # elements j, j+L, j+2L, ...
    F = np.ones((T, L), np.uint64)
    C = np.zeros((T, L), np.uint64)
    A = np.zeros((T, L), bool)
    for j in range(L):
        idx = np.arange(j, n, L)
        k = idx.size
        F[:k, j] = f_all[idx][::-1]
        C[:k, j] = c_all[idx][::-1]
        A[:k, j] = True
    x = np.full(L, _STATE_LO, np.uint64)
    emitted: list[list[int]] = [[] for _ in range(L)]
    u16 = np.uint64(16)
    u20 = np.uint64(20)
    pb = np.uint64(PROB_BITS)
    mask16 = np.uint64(0xFFFF)
    for t in range(T):
        act = A[t]
        f = F[t]
        # invariant x < 2^32; renorm target (f << 20) >= 2^20, so one
        # 16-bit emit always suffices (post-shift x < 2^16 <= f << 20)
        emit = act & (x >= (f << u20))
        if emit.any():
            for j in np.flatnonzero(emit):
                emitted[j].append(int(x[j] & mask16))
            x[emit] >>= u16
        xa = x[act]
        fa = f[act]
        x[act] = ((xa // fa) << pb) + (xa % fa) + C[t][act]
    present = np.flatnonzero(freqs)
    out = bytearray()
    out += struct.pack("<BH", L, present.size)
    for s in present.tolist():
        out += struct.pack("<BH", s, int(freqs[s]) & 0xFFFF)  # _M -> 0
    streams = []
    for j in range(L):
        # stream bytes in DECODE read order = reverse of emission
        vals = np.asarray(emitted[j][::-1], dtype="<u2")
        streams.append(vals.tobytes())
        out += struct.pack("<II", int(x[j]), len(streams[-1]))
    for s_bytes in streams:
        out += s_bytes
    return bytes(out)


def _rans_decode(body: bytes, n_bytes: int) -> bytes:
    if len(body) < 3:
        raise ValueError("rANS body truncated")
    L, n_sym = struct.unpack_from("<BH", body, 0)
    off = 3
    freqs = np.zeros(256, np.int64)
    for _ in range(n_sym):
        s, fq = struct.unpack_from("<BH", body, off)
        off += 3
        freqs[s] = fq if fq else _M  # 0 encodes the full-table freq _M
    if int(freqs.sum()) != _M:
        raise ValueError("rANS frequency table does not sum to 2^PROB_BITS")
    cum = np.zeros(256, np.int64)
    cum[1:] = np.cumsum(freqs)[:-1]
    present = np.flatnonzero(freqs)
    slot_sym = np.repeat(present, freqs[present]).astype(np.uint8)
    x = np.zeros(L, np.uint64)
    lane_off = np.zeros(L, np.int64)
    lane_end = np.zeros(L, np.int64)
    for j in range(L):
        st, ln = struct.unpack_from("<II", body, off)
        off += 8
        x[j] = st
        lane_off[j] = ln  # temp: lengths
    start = off
    for j in range(L):
        ln = int(lane_off[j])
        lane_off[j] = start
        lane_end[j] = start + ln
        start += ln
    if start != len(body):
        raise ValueError("rANS streams do not fill the body")
    data = np.frombuffer(body, np.uint8)
    out = np.empty(n_bytes, np.uint8)
    per_lane = np.array([(n_bytes - j + L - 1) // L for j in range(L)])
    T = int(per_lane.max()) if n_bytes else 0
    maskM = np.uint64(_M - 1)
    u16 = np.uint64(16)
    pb = np.uint64(PROB_BITS)
    lo = np.uint64(_STATE_LO)
    freqs_u = freqs.astype(np.uint64)
    cum_u = cum.astype(np.uint64)
    for t in range(T):
        act = t < per_lane
        slot = x & maskM
        sym = slot_sym[slot.astype(np.int64)]
        js = np.flatnonzero(act)
        out[js + t * L] = sym[js]
        f = freqs_u[sym]
        c = cum_u[sym]
        nx = f * (x >> pb) + slot - c
        x = np.where(act, nx, x)
        need = act & (x < lo)
        for j in np.flatnonzero(need):
            if lane_off[j] + 2 > lane_end[j]:
                raise ValueError("rANS lane stream exhausted")
            v = int(data[lane_off[j]]) | (int(data[lane_off[j] + 1]) << 8)
            x[j] = (x[j] << u16) | np.uint64(v)
            lane_off[j] += 2
    if not np.array_equal(lane_off, lane_end):
        raise ValueError("rANS lane stream not fully consumed")
    return out.tobytes()


# ---------------------------------------------------------------------------
# mode selection
# ---------------------------------------------------------------------------

def encode(data: bytes) -> tuple[int, bytes]:
    """Encode one packed plane payload; returns ``(mode, body)`` with
    the smallest body among raw / RLE / rANS — ``len(body) <=
    len(data)`` ALWAYS (raw is always a candidate)."""
    arr = np.frombuffer(data, np.uint8)
    best_mode, best = MODE_RAW, bytes(data)
    rle = _rle_encode(arr)
    if rle is not None and len(rle) < len(best):
        best_mode, best = MODE_RLE, rle
    if arr.size:
        counts = np.bincount(arr, minlength=256)
        p = counts[counts > 0] / arr.size
        est_bits = float(-(p * np.log2(p)).sum()) * arr.size
        est = est_bits / 8 + _rans_overhead(p.size, _n_lanes(arr.size))
        if est < len(best):
            rans = _rans_encode(arr)
            if rans is not None and len(rans) < len(best):
                best_mode, best = MODE_RANS, rans
    return best_mode, best


def decode(mode: int, body: bytes, n_bytes: int) -> bytes:
    """Exact inverse of :func:`encode` for a known decoded size."""
    if mode == MODE_RAW:
        if len(body) != n_bytes:
            raise ValueError(
                f"raw payload is {len(body)} bytes, expected {n_bytes}")
        return bytes(body)
    if mode == MODE_RLE:
        return _rle_decode(body, n_bytes)
    if mode == MODE_RANS:
        return _rans_decode(body, n_bytes)
    raise ValueError(f"unknown entropy mode {mode}")
