"""Progressive client: byte stream -> device-resident PlaneStore.

Counterpart of ``src/repro/transmission/client.py``. Consumes the wire
format of :mod:`repro_torch.core.wire` incrementally, at any chunk
boundary (a transport delivers bytes, not planes). Each completed plane
is unpacked on the store's device, and each completed stage is ORed into
the :class:`~repro_torch.core.plane_store.PlaneStore` in one batched
``plane_or_segments`` launch per container dtype (eq. 4).

Fault tolerance (wire v3)
-------------------------
The OR is irreversible, so on a v3 stream the client verifies before it
ingests:

* every unit's CRC32 and sequence number are checked the moment its
  bytes are complete, before any decode or OR;
* a unit that fails is **quarantined**: its bytes are consumed (lengths
  come from the header, so the stream stays in sync), nothing reaches
  the store, and a NACK is recorded for the transport to re-request
  (:meth:`ProgressiveClient.feed_repair`);
* verified units are ORed strictly in sequence order: a verified unit
  behind an unrepaired gap is held, which keeps each tensor's planes
  MSB-first and the store bit-identical to the clean stream's at every
  checkpoint;
* :attr:`ProgressiveClient.resume_cursor` is the durable resume point
  ``(unit_seq, byte_offset)``.

Host memory: the client drops bytes it has consumed and slices units out
of its buffer without copying them; only packed bytes go to the card.
The reference's telemetry calls (off by default there) are left out
until telemetry is ported (ROADMAP A11).
"""
from __future__ import annotations

import struct
from typing import Callable

from repro_torch import resolve_device
from repro_torch.core import wire
from repro_torch.core.plane_store import PlaneStore
from repro_torch.core.quantize import container_dtype


class ProgressiveClient:
    """Incremental decoder of the progressive wire format. The store
    lives on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, on_stage_complete: Callable[[int], None] | None = None,
                 *, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "a sharded client store (mesh=) is still to be ported (ROADMAP A13)")
        self.device = resolve_device(device)
        self._buf = bytearray()
        self._base = 0            # absolute offset of self._buf[0]
        self._meta = None
        self._layout: wire.StageLayout | None = None
        self.store: PlaneStore | None = None
        self._pending: list = []  # (tensor_idx, plane) decoded, not ORed yet
        self._cursor = 0          # absolute offset of next undecoded byte
        self._stage = 0           # completed stages
        self._entry = 0           # next entry within current stage
        self._on_stage_complete = on_stage_complete
        # -- v3 integrity state (inert for v1/v2 streams) ------------------
        self.header_failed = False      # header CRC mismatch: resend from 0
        self._units: list[tuple[int, int, int, int]] = []  # flat entries
        self._unit_offsets: list[int] = []
        self._checkpoints: list[int] = []
        self._next_unit = 0             # stream position, in units
        self._ready: dict[int, tuple] = {}  # seq -> (tensor_idx, plane)
        self._verified: set[int] = set()
        self._nacks: dict[int, str] = {}    # seq -> quarantine reason
        self._contig = 0                # all seq < _contig verified
        self._ingested_upto = 0         # all seq < this ORed (or queued)
        self.quarantine_log: list[dict] = []
        self.duplicate_units = 0

    # -- feeding -----------------------------------------------------------
    def feed(self, chunk) -> None:
        if self.header_failed:
            # the transport restarts the stream from byte 0 (resume_cursor)
            self.header_failed = False
        self._buf += chunk
        self._advance()
        if self._meta is not None and self._cursor > self._base:
            # consumed bytes are never read again
            del self._buf[:self._cursor - self._base]
            self._base = self._cursor

    @property
    def stages_complete(self) -> int:
        return self._stage

    @property
    def bytes_fed(self) -> int:
        return self._base + len(self._buf)

    @property
    def complete(self) -> bool:
        if self._layout is None:
            return False
        if self.integrity:
            return self._stage == len(self._checkpoints)
        return self._stage == len(self._layout.stages)

    @property
    def header_ready(self) -> bool:
        return self._meta is not None

    @property
    def expected_total_bytes(self) -> int | None:
        return self._layout.total_bytes if self._layout else None

    @property
    def integrity(self) -> bool:
        """True once a v3 (integrity-framed) header has been decoded."""
        return bool(self._layout is not None and self._layout.integrity)

    # -- v3 transport interface --------------------------------------------
    @property
    def nacks(self) -> dict[int, str]:
        """Quarantined units awaiting re-request: ``{seq: reason}``."""
        return dict(self._nacks)

    @property
    def resume_cursor(self) -> tuple[int, int]:
        """Durable resume point ``(unit_seq, byte_offset)``: the first
        unit whose bytes have not fully arrived, and its absolute wire
        offset. Everything before it arrived (verified or NACKed; NACKs
        are repaired per unit), so a reconnect replays from here.
        ``(0, 0)`` until the header verifies."""
        if not self.integrity:
            if self._layout is None:
                return (0, 0)
            done = sum(len(s) for s in self._layout.stages[:self._stage])
            return (done + self._entry, self._cursor)
        if self._next_unit >= len(self._units):
            return (len(self._units), self._layout.total_bytes)
        return (self._next_unit, self._unit_offsets[self._next_unit])

    @property
    def verified_units(self) -> int:
        return len(self._verified)

    def drop_unconsumed(self) -> int:
        """Discard buffered bytes past the last complete unit (a partial
        frame cut off by a disconnect). The transport replays from
        :attr:`resume_cursor` after this; returns the bytes dropped."""
        start = self._cursor - self._base
        dropped = len(self._buf) - start
        if dropped > 0:
            del self._buf[start:]
        return dropped

    def rewind_to_gap(self) -> tuple[int, int]:
        """Resync after the transport detects a desynchronized stream
        (truncation, duplication, reordering): drop unconsumed bytes,
        rewind the stream position to the first unverified unit and clear
        the quarantine entries at or after it (they re-arrive in-stream);
        verified units past the gap are skipped as duplicates on replay.
        Returns the ``(unit_seq, byte_offset)`` to replay from."""
        if not self.integrity:
            raise RuntimeError("rewind_to_gap requires a v3 integrity stream")
        self.drop_unconsumed()
        gap = self._contig
        for seq in [s for s in self._nacks if s >= gap]:
            del self._nacks[seq]
        self._next_unit = gap
        if gap >= len(self._units):
            return (gap, self._layout.total_bytes)
        return (gap, self._unit_offsets[gap])

    def feed_repair(self, seq: int, payload) -> bool:
        """Deliver a re-requested unit out of band: its full on-wire bytes,
        integrity frame included, verified like stream bytes. A corrupt
        repair stays quarantined (False) and its NACK survives; repairing
        an already-verified unit is a dropped duplicate (True)."""
        if not self.integrity:
            raise RuntimeError("feed_repair requires a v3 integrity stream")
        if seq < 0 or seq >= len(self._units):
            raise ValueError(f"repair seq {seq} out of range")
        if seq in self._verified:
            self.duplicate_units += 1
            return True
        ok = self._verify_and_stash(seq, payload, origin="repair")
        if ok:
            self._nacks.pop(seq, None)
            self._advance_contig()
        return ok

    # -- internal machinery --------------------------------------------------
    def _advance(self) -> None:
        if self._meta is None:
            if not self._try_header():
                return
        if self._layout.integrity:
            self._advance_v3()
        else:
            self._advance_stream()

    def _try_header(self) -> bool:
        if len(self._buf) < 12:
            return False
        version, n = struct.unpack("<II", self._buf[4:12])
        if version == wire.VERSION_INTEGRITY and n > wire.MAX_HEADER_BYTES:
            # a corrupted length field would stall the stream forever;
            # flag it so the transport restarts from byte 0
            self._quarantine_header(
                f"header declares {n} body bytes (cap {wire.MAX_HEADER_BYTES})")
            return False
        hdr_len = 12 + n
        if version == wire.VERSION_INTEGRITY:
            hdr_len += wire.HEADER_CRC_BYTES
        if len(self._buf) < hdr_len:
            return False
        try:
            self._meta, hdr = wire.decode_header(bytes(self._buf[:hdr_len]))
        except wire.WireFormatError as e:
            # only a v3 stream recovers from a bad header (the transport
            # restarts it); v1/v2 keep the hard error
            if version == wire.VERSION_INTEGRITY:
                self._quarantine_header(str(e))
                return False
            raise
        self._layout = wire.layout_from_header(self._meta, hdr)
        self._cursor = hdr
        self.store = PlaneStore.from_wire_meta(self._meta, device=self.device)
        if self._layout.integrity:
            self._units = [e for st in self._layout.stages for e in st]
            self._unit_offsets = self._layout.unit_offsets()
            cps, acc = [], 0
            for st in self._layout.stages:
                acc += len(st)
                cps.append(acc)
            self._checkpoints = cps
        return True

    def _quarantine_header(self, reason: str) -> None:
        self.header_failed = True
        self._meta = None
        self._buf.clear()
        self._base = self._cursor = 0
        self.quarantine_log.append({"seq": None, "target": "header", "reason": reason})

    def _unit_bytes(self, nbytes: int):
        """A view of the next ``nbytes`` stream bytes, or None before they
        have all arrived. Callers drop the view before the buffer changes."""
        start = self._cursor - self._base
        if len(self._buf) - start < nbytes:
            return None
        return memoryview(self._buf)[start:start + nbytes]

    def _decode(self, payload, width: int, n_el: int, framed: bool):
        return wire.decode_plane(payload, width, n_el, framed=framed, device=self.device,
                                 dtype=container_dtype(width))

    # -- v1/v2: trusted in-order stream -------------------------------------
    def _advance_stream(self) -> None:
        # decode completed planes; the eq. (4) OR runs once a stage completes
        while self._stage < len(self._layout.stages):
            entries = self._layout.stages[self._stage]
            while self._entry < len(entries):
                idx, w, nbytes, n_el = entries[self._entry]
                payload = self._unit_bytes(nbytes)
                if payload is None:
                    return
                self._pending.append((idx, self._decode(payload, w, n_el,
                                                        self._layout.framed)))
                del payload
                self._cursor += nbytes
                self._entry += 1
            self._stage += 1
            self._entry = 0
            self._flush()
            if self._on_stage_complete:
                self._on_stage_complete(self._stage)

    # -- v3: verify-before-ingest --------------------------------------------
    def _advance_v3(self) -> None:
        while self._next_unit < len(self._units):
            seq = self._next_unit
            payload = self._unit_bytes(self._units[seq][2])
            if payload is None:
                break
            self._cursor += len(payload)
            self._next_unit += 1
            if seq in self._verified:
                # duplicated bytes on the stream (a unit already repaired)
                self.duplicate_units += 1
            elif self._verify_and_stash(seq, payload, origin="stream"):
                self._nacks.pop(seq, None)
            del payload
        self._advance_contig()

    def _verify_and_stash(self, seq: int, payload, origin: str) -> bool:
        """CRC- and seq-check one on-wire unit; decode and stage it for
        in-order ingest on success, quarantine it on failure. A decode
        error after a passing CRC (possible only for a repair of the
        wrong length) quarantines too: nothing unverified reaches the
        store."""
        idx, w, nbytes, n_el = self._units[seq]
        reason = None
        try:
            got_seq, body = wire.verify_unit(payload)
            if got_seq != seq:
                reason = f"sequence mismatch: frame says {got_seq}, " \
                         f"stream position says {seq}"
            elif len(payload) != nbytes:
                reason = (f"unit is {len(payload)} bytes on the wire, "
                          f"header says {nbytes}")
        except wire.WireFormatError as e:
            reason = str(e)
        if reason is None:
            try:
                plane = self._decode(body, w, n_el, True)
            except wire.WireFormatError as e:
                reason = f"verified frame but undecodable body: {e}"
        if reason is not None:
            self._nacks[seq] = reason
            self.quarantine_log.append({"seq": seq, "origin": origin, "reason": reason})
            return False
        self._ready[seq] = (idx, plane)
        self._verified.add(seq)
        return True

    def _advance_contig(self) -> None:
        """Advance the verified-prefix pointer, and OR ready units in
        strict sequence order whenever it crosses a checkpoint, so the
        store at each stage completion is bit-identical to the clean
        stream's."""
        while self._contig in self._verified:
            self._contig += 1
        while (self._stage < len(self._checkpoints)
               and self._checkpoints[self._stage] <= self._contig):
            self._ingest_ready_below(self._checkpoints[self._stage])
            self._flush()
            self._stage += 1
            if self._on_stage_complete:
                self._on_stage_complete(self._stage)

    def _ingest_ready_below(self, bound: int) -> None:
        """Queue verified units with seq in [_ingested_upto, bound) for
        the batched OR, in sequence order (each tensor's planes stay
        MSB-first); callers guarantee the range is fully verified."""
        for seq in range(self._ingested_upto, bound):
            self._pending.append(self._ready.pop(seq))
        self._ingested_upto = max(self._ingested_upto, bound)

    def _flush(self) -> None:
        """Push buffered planes into the store: one batched OR launch per
        container dtype (per plane round)."""
        if self._pending:
            self.store.ingest(self._pending)
            self._pending = []

    # -- inference-side view -------------------------------------------------
    def materialize(self):
        """The current float parameters as a flat ``{path: tensor}`` dict
        (eq. 5). Planes of a partly received stage are ORed first; on a v3
        stream only the verified contiguous prefix is, so no unit behind a
        quarantined gap reaches the accumulators early."""
        if self.store is None:
            raise RuntimeError("header not received yet")
        if self.integrity:
            self._ingest_ready_below(self._contig)
        self._flush()
        return dict(self.store.materialize_leaves())
