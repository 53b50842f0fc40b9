"""Wire format for progressive model transmission (v1, v2 and v3).

Counterpart of ``src/repro/core/wire.py``: for the same model the port
writes the reference's bytes, and each package decodes the other's.

v1 layout (all little-endian):

    [HEADER]   MAGIC, <version u32><json length u32>, json: per-tensor
               path/shape/dtype/lo/hi, plane schedule. Shipped first.
    [STAGE 1]  the dense bit-packed planes of stage 1, in priority order
    ...
    [STAGE n]

v2 (``encode(model, schedule=..., entropy_coded=...)``) ships an explicit
(tensor, plane) *unit* list carried in the header ("units",
"checkpoints" standing in for stage ends, "unit_bytes", "entropy"), each
unit ``<mode u8><reserved u8>`` + the raw or entropy-coded packed plane
(:mod:`repro_torch.core.entropy`).

v3 (``encode(model, integrity=True)``) is v2 with an 8-byte frame
``<seq u32><crc u32>`` before every unit (the CRC32 covers seq and the
unit) and a CRC32 of the whole header after it, so a client verifies a
unit before the irreversible OR (:mod:`repro_torch.transmission.client`).

Planes are packed on the device they lie on; only packed bytes cross to
the host. :func:`decode_plane` uploads a unit's packed bytes and unpacks
them on the target device, so a card receives 2 bits a weight for a
2-bit plane, never the unpacked values.
"""
from __future__ import annotations

import dataclasses
import json
import struct
import zlib

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import bitplanes, entropy
from repro_torch.core.plane_store import dtype_name
from repro_torch.core.progressive import ProgressiveModel

MAGIC = b"PGNJ"
VERSION = 1            # stage-major stream (the default)
VERSION_SCHEDULED = 2  # scheduled/entropy-coded unit stream
VERSION_INTEGRITY = 3  # integrity-framed unit stream (CRC + seq)
SUPPORTED_VERSIONS = (VERSION, VERSION_SCHEDULED, VERSION_INTEGRITY)
FRAME_BYTES = 2        # v2 per-unit frame: <mode u8><reserved u8>
HEADER_CRC_BYTES = 4   # v3: CRC32 of the full header, appended to it
FRAME_BYTES_V3 = 10    # v3 per-unit frame: <seq u32><crc u32><mode u8><u8>
# Plausibility cap on the header's declared JSON length: a corrupted
# length field must not make a client wait forever for bytes that will
# never come.
MAX_HEADER_BYTES = 1 << 28


class WireFormatError(ValueError):
    """Malformed wire bytes (truncation, garbage, bad lengths), raised
    with offset context instead of a bare struct/json/index error."""


class WireIntegrityError(WireFormatError):
    """v3 integrity violation: CRC mismatch. Receivers route it to
    quarantine and re-request instead of treating the stream as
    unparseable."""


def path_str(path: tuple) -> str:
    """Render a tree path as 'a/b/0/c': the reference's rendering of the
    same dict keys."""
    return "/".join(str(p) for p in path)


def _tensor_meta(model: ProgressiveModel) -> list[dict]:
    return [
        {
            "path": path_str(t.path),
            "shape": list(t.shape),
            "dtype": dtype_name(t.orig_dtype),
            "lo": float(t.lo),
            "hi": float(t.hi),
            "bits": t.plan.schedule.bits,
            "widths": list(t.plan.schedule.widths),
            "priority": t.plan.priority,
            "slice_axis": t.slice_axis,
            "slice_idx": t.slice_idx,
            "n_slices": t.n_slices,
        }
        for t in model.tensors
    ]


def encode_header(model: ProgressiveModel) -> bytes:
    meta = {
        "version": VERSION,
        "n_stages": model.n_stages,
        "tensors": _tensor_meta(model),
    }
    body = json.dumps(meta).encode()
    return MAGIC + struct.pack("<II", VERSION, len(body)) + body


def decode_header(buf):
    """Parse the stream header. Returns ``(meta, header_bytes)``.

    Malformed input raises :class:`WireFormatError` with offset context;
    a v3 header whose trailing CRC32 does not cover its bytes raises
    :class:`WireIntegrityError`."""
    if len(buf) < 12:
        raise WireFormatError(
            f"truncated header: need 12 prefix bytes, have {len(buf)}")
    if bytes(buf[:4]) != MAGIC:
        raise WireFormatError(
            f"bad magic at offset 0: {bytes(buf[:4])!r} != {MAGIC!r}")
    version, n = struct.unpack("<II", buf[4:12])
    if version not in SUPPORTED_VERSIONS:
        raise WireFormatError(f"unsupported version {version} at offset 4")
    if n > MAX_HEADER_BYTES:
        raise WireFormatError(
            f"header declares {n} body bytes at offset 8 "
            f"(cap {MAX_HEADER_BYTES}) — length field is corrupt")
    end = 12 + n
    if len(buf) < end:
        raise WireFormatError(
            f"truncated header: body ends at offset {end}, have {len(buf)}")
    if version == VERSION_INTEGRITY:
        if len(buf) < end + HEADER_CRC_BYTES:
            raise WireFormatError(
                f"truncated header: v3 CRC ends at offset "
                f"{end + HEADER_CRC_BYTES}, have {len(buf)}")
        (crc,) = struct.unpack("<I", buf[end:end + HEADER_CRC_BYTES])
        got = zlib.crc32(buf[:end]) & 0xFFFFFFFF
        if got != crc:
            raise WireIntegrityError(
                f"header CRC mismatch over [0, {end}): "
                f"computed {got:#010x}, stored {crc:#010x}")
        end += HEADER_CRC_BYTES
    try:
        meta = json.loads(bytes(buf[12:12 + n]).decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise WireFormatError(
            f"unparseable header body at offsets [12, {12 + n}): {e}"
        ) from None
    if not isinstance(meta, dict) or "tensors" not in meta:
        raise WireFormatError(
            f"header body at offsets [12, {12 + n}) is valid JSON but "
            f"not a wire header (missing 'tensors')")
    if meta.get("version", version) != version:
        # the prefix version selects whether a CRC exists at all, so the
        # CRC cannot cover it: a flipped prefix byte must not demote a v3
        # stream to an unchecked v2 parse
        raise WireFormatError(
            f"version mismatch: prefix says {version} at offset 4, "
            f"header body says {meta['version']}")
    return meta, end


def _packed(plane: torch.Tensor, width: int) -> np.ndarray:
    """One plane's packed bytes, packed on its device, on the host."""
    return bitplanes.pack_bits(plane, width).cpu().numpy()


def encode_stage(model: ProgressiveModel, s: int) -> bytes:
    """Dense bit-packed payload of one stage (sizes follow from the
    header, so no per-plane framing)."""
    return b"".join(_packed(plane, model.tensors[idx].plan.schedule.widths[s - 1])
                    for idx, plane in model.stage(s))


def encode_unit(model: ProgressiveModel, t_idx: int, p: int,
                *, entropy_coded: bool = False) -> bytes:
    """One v2 shipment unit: 2-byte frame + (raw | entropy-coded) packed
    plane ``p`` of tensor ``t_idx``. Coded only when it wins, so the
    unit is never larger than the raw packed plane + FRAME_BYTES."""
    t = model.tensors[t_idx]
    packed = _packed(t.planes[p], t.plan.schedule.widths[p])
    if entropy_coded:
        mode, body = entropy.encode(packed.tobytes())
    else:
        mode, body = entropy.MODE_RAW, packed
    return struct.pack("<BB", mode, 0) + memoryview(body)


def _unit_meta(model: ProgressiveModel, schedule, version: int, payloads: list,
               entropy_coded: bool) -> bytes:
    meta = {
        "version": version,
        "n_stages": len(schedule.checkpoints),
        "tensors": _tensor_meta(model),
        "units": [[int(t), int(p)] for t, p in schedule.units],
        "checkpoints": [int(c) for c in schedule.checkpoints],
        "unit_bytes": [len(u) for u in payloads],
        "entropy": bool(entropy_coded),
    }
    body = json.dumps(meta).encode()
    return MAGIC + struct.pack("<II", version, len(body)) + body


def encode_v2(model: ProgressiveModel, schedule=None,
              *, entropy_coded: bool = True) -> bytes:
    """Scheduled/entropy-coded stream. ``schedule`` is a
    :class:`~repro_torch.core.calibrate.TransmissionSchedule`; ``None``
    takes the v1 stage-major order. Unit sizes depend on the data, so
    payloads are encoded first and their sizes recorded in the header."""
    if schedule is None:
        from repro_torch.core.calibrate import uniform_schedule
        schedule = uniform_schedule(model)
    payloads = [encode_unit(model, t, p, entropy_coded=entropy_coded)
                for t, p in schedule.units]
    header = _unit_meta(model, schedule, VERSION_SCHEDULED, payloads, entropy_coded)
    return header + b"".join(payloads)


def frame_unit(seq: int, unit: bytes) -> bytes:
    """Wrap a v2-framed unit (``<mode u8><reserved u8>`` + payload) in
    the v3 integrity frame. The CRC covers the sequence number and the
    unit, so any flipped bit of the on-wire unit fails verification."""
    seq_b = struct.pack("<I", seq)
    crc = zlib.crc32(unit, zlib.crc32(seq_b)) & 0xFFFFFFFF
    return seq_b + struct.pack("<I", crc) + unit


def verify_unit(payload) -> tuple[int, memoryview]:
    """Check a v3 unit's integrity frame. Returns ``(seq, body)``, where
    ``body`` is a view of the v2-framed unit within ``payload`` (feed it
    to ``decode_plane(..., framed=True)``). Raises
    :class:`WireIntegrityError` on a CRC mismatch and
    :class:`WireFormatError` on truncation."""
    if len(payload) < FRAME_BYTES_V3:
        raise WireFormatError(
            f"v3 unit shorter than its {FRAME_BYTES_V3}-byte frame: "
            f"{len(payload)} bytes")
    view = memoryview(payload)
    seq, crc = struct.unpack("<II", view[:8])
    body = view[8:]
    got = zlib.crc32(body, zlib.crc32(view[:4])) & 0xFFFFFFFF
    if got != crc:
        raise WireIntegrityError(
            f"unit CRC mismatch (frame claims seq {seq}): "
            f"computed {got:#010x}, stored {crc:#010x}")
    return seq, body


def encode_v3(model: ProgressiveModel, schedule=None,
              *, entropy_coded: bool = False) -> bytes:
    """Integrity-framed stream: v2's unit layout with a per-unit
    ``<seq u32><crc u32>`` frame and a whole-header CRC32. The bytes
    inside each frame are exactly the v2 unit."""
    if schedule is None:
        from repro_torch.core.calibrate import uniform_schedule
        schedule = uniform_schedule(model)
    payloads = [frame_unit(seq, encode_unit(model, t, p, entropy_coded=entropy_coded))
                for seq, (t, p) in enumerate(schedule.units)]
    header = _unit_meta(model, schedule, VERSION_INTEGRITY, payloads, entropy_coded)
    header += struct.pack("<I", zlib.crc32(header) & 0xFFFFFFFF)
    return header + b"".join(payloads)


def framing_overhead(meta: dict) -> dict:
    """v3 integrity-framing overhead from a decoded header: bytes, and
    their share of the unit bytes. Zero for v1/v2."""
    version = meta.get("version", VERSION)
    if version != VERSION_INTEGRITY:
        return {"version": version, "overhead_bytes": 0, "overhead_frac": 0.0}
    n_units = len(meta["units"])
    overhead = HEADER_CRC_BYTES + n_units * (FRAME_BYTES_V3 - FRAME_BYTES)
    total = sum(meta["unit_bytes"])
    return {
        "version": version,
        "n_units": n_units,
        "overhead_bytes": overhead,
        "overhead_frac": overhead / max(total, 1),
        "per_unit_bytes": FRAME_BYTES_V3 - FRAME_BYTES,
    }


def encode(model: ProgressiveModel, *, schedule=None,
           entropy_coded: bool = False, integrity: bool = False) -> bytes:
    """v1 by default; a schedule and/or entropy coding selects v2;
    ``integrity=True`` the v3 framing (composable with both)."""
    if integrity:
        return encode_v3(model, schedule, entropy_coded=entropy_coded)
    if schedule is None and not entropy_coded:
        return encode_header(model) + b"".join(
            encode_stage(model, s) for s in range(1, model.n_stages + 1))
    return encode_v2(model, schedule, entropy_coded=entropy_coded)


@dataclasses.dataclass
class StageLayout:
    """Byte layout derived from the header alone: what a client needs to
    slice an incoming stream into (tensor, plane) payloads.

    v1: one stage per plane rank, entries dense-packed. v2
    (``framed=True``): "stages" are checkpoint groups of units; each
    entry's ``payload_bytes`` includes the 2-byte frame. v3
    (``integrity=True``): payloads also carry the 8-byte integrity frame
    and must pass :func:`verify_unit` before :func:`decode_plane`."""

    header_bytes: int
    # per stage: list of (tensor_idx, width, payload_bytes, n_elements)
    stages: list[list[tuple[int, int, int, int]]]
    framed: bool = False
    integrity: bool = False

    def unit_offsets(self) -> list[int]:
        """Absolute wire offset of each unit's first byte, flattened
        across stages (what a resume cursor or re-request indexes)."""
        offs, off = [], self.header_bytes
        for st in self.stages:
            for e in st:
                offs.append(off)
                off += e[2]
        return offs

    @property
    def stage_bytes(self) -> list[int]:
        return [sum(e[2] for e in st) for st in self.stages]

    @property
    def total_bytes(self) -> int:
        return self.header_bytes + sum(self.stage_bytes)


def _n_elements(shape) -> int:
    return int(np.prod(shape)) if shape else 1


def layout_from_header(meta: dict, header_bytes: int) -> StageLayout:
    version = meta.get("version", VERSION)
    if version in (VERSION_SCHEDULED, VERSION_INTEGRITY):
        return _layout_v2(meta, header_bytes, integrity=version == VERSION_INTEGRITY)
    order = sorted(range(len(meta["tensors"])),
                   key=lambda i: (meta["tensors"][i]["priority"], i))
    stages = []
    for s in range(1, meta["n_stages"] + 1):
        entries = []
        for i in order:
            t = meta["tensors"][i]
            if s <= len(t["widths"]):
                w = t["widths"][s - 1]
                n_el = _n_elements(t["shape"])
                entries.append((i, w, -(-n_el * w // 8), n_el))
        stages.append(entries)
    return StageLayout(header_bytes=header_bytes, stages=stages)


def _layout_v2(meta: dict, header_bytes: int, *, integrity: bool = False) -> StageLayout:
    units = meta["units"]
    unit_bytes = meta["unit_bytes"]
    if len(unit_bytes) != len(units):
        raise ValueError("unit_bytes length mismatch")
    entries = []
    for (t_idx, p), nbytes in zip(units, unit_bytes):
        t = meta["tensors"][t_idx]
        entries.append((int(t_idx), int(t["widths"][p]), int(nbytes),
                        _n_elements(t["shape"])))
    stages, lo = [], 0
    for cp in meta["checkpoints"]:
        stages.append(entries[lo:cp])
        lo = cp
    if lo != len(entries):
        raise ValueError("checkpoints do not cover all units")
    return StageLayout(header_bytes=header_bytes, stages=stages, framed=True,
                       integrity=integrity)


def _upload(payload, device: torch.device) -> torch.Tensor:
    """Packed bytes as a uint8 tensor on ``device``; a card gets them
    through pinned memory with an asynchronous copy."""
    src = np.frombuffer(payload, dtype=np.uint8)
    if device.type != "cuda":
        return torch.from_numpy(src.copy())
    host = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
    host.numpy()[:] = src
    return host.to(device, non_blocking=True)


def decode_plane(payload, width: int, n_elements: int, *, framed: bool = False,
                 device="cuda", dtype: torch.dtype = torch.uint32) -> torch.Tensor:
    """Unpack one plane payload onto ``device`` as ``dtype`` (the
    reference returns uint32; a client passes the plane's container
    dtype). ``framed=True`` (a v2/v3 unit) strips the 2-byte mode frame
    and undoes entropy coding first, on the host. Malformed input raises
    :class:`WireFormatError`. v3 callers verify and strip the integrity
    frame with :func:`verify_unit` first."""
    raw_len = -(-n_elements * width // 8)
    if framed:
        if len(payload) < FRAME_BYTES:
            raise WireFormatError(
                f"framed payload shorter than its {FRAME_BYTES}-byte "
                f"frame: {len(payload)} bytes")
        mode = payload[0]
        try:
            payload = entropy.decode(mode, payload[FRAME_BYTES:], raw_len)
        except Exception as e:
            raise WireFormatError(
                f"undecodable unit body (mode {mode}, "
                f"{len(payload) - FRAME_BYTES} coded bytes for "
                f"{raw_len} raw): {e}") from None
    if len(payload) != raw_len:
        raise WireFormatError(
            f"plane payload is {len(payload)} bytes, expected {raw_len} "
            f"({n_elements} elements x {width} bits)")
    packed = _upload(payload, resolve_device(device))
    return bitplanes.unpack_bits(packed, width, n_elements, dtype=dtype)
