"""Progressive serving: a server starts with the MSB planes of the
weights, serves at once, and upgrades precision in place between decode
steps as later planes arrive. The KV cache survives every upgrade.

Counterpart of ``src/repro/serving/engine.py``, for two engines over
the same precision machinery, each in pull mode or fed from wire bytes
through a :class:`WireStoreReceiver`:

* :class:`ProgressiveServer`: one lock-stepped request stream;
* :class:`SlotPoolEngine`: continuous batching over a fixed pool of
  decode slots, with chunked prefill admitting requests mid-flight.

The accumulators live in a PlaneStore; an upgrade ORs a stage into them
with one ``plane_or_segments`` launch per container dtype. What a
decode step sees is set by ``resident``:

* ``"fp"`` (the paper's client, the default): each upgrade dequantizes
  the touched tensors into float leaves (eq. 5, incremental), and the
  dense layers are plain matmuls on them;
* ``"quantized"``: the live parameter tree holds
  :class:`~repro_torch.core.quantize.QuantizedTensor` views of the
  accumulators, eq. (5) runs inside every matmul
  (``kernels/dequant_matmul``) and no float weight buffer exists; an
  upgrade changes scale/offset values only.

With ``mesh=`` (a ``launch.mesh`` serving mesh) the accumulators are a
:class:`~repro_torch.core.plane_store.ShardedPlaneStore` split over the
mesh's model shards, weights split on their output dim run a shard at a
time (``ops.sharded_dequant_matmul``, or a float matmul a shard) and are
gathered on the home device, where everything else runs: token-identical
to one device at every stage (see ``launch/sharding.py``).

Telemetry (``repro_torch.obs``, off by default; ``REPRO_TELEMETRY=1`` or
``obs.configure(True)``) mirrors the reference's spans, counters and
histograms from values the engines already hold on the host: the
upgrade's ingest and refresh split, each window's wall time and counts,
each request's time to first token, each upgrade's record. No site reads
the device or launches anything.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs as _obs
from repro_torch import resolve_device, to_device
from repro_torch.core import wire
from repro_torch.core.progressive import (ProgressiveModel, ReceiverState, rebuild_params,
                                          tree_flatten_with_path)
from repro_torch.core.plane_store import ShardedLeaf
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.launch.mesh import home_device
from repro_torch.models.common import quantized_resident_eligible
from repro_torch.models.model import Model
from repro_torch.models.ssm import RECURRENT_KINDS
from repro_torch.models.transformer import attn_window, recurrent_kinds

RESIDENT_MODES = ("fp", "quantized")


@dataclasses.dataclass
class GenerationResult:
    tokens: Any           # (B, steps) generated token ids
    stage_at_step: list   # precision stage used for each decode step
    upgrades: list        # (step, stage) upgrade events
    per_step_s: list      # window wall time / steps in the window
    window_s: list = dataclasses.field(default_factory=list)
    #                     # (steps_in_window, wall_seconds) per flushed window
    ttft_s: float = 0.0   # wall time until the first window's tokens are done
    tpot_s: float = 0.0   # total wall time / steps
    mode: str = "sync"    # "sync" (wait per token) | "async" (windowed)


def keystr(path: tuple) -> str:
    """``['a']['b']``: ``jax.tree_util.keystr`` of a dict path."""
    return "".join(f"[{k!r}]" for k in path)


def resident_report(params) -> dict:
    """Leaf-type audit of a live parameter tree: how many leaves are
    quantized-resident vs float, and the device bytes each side holds.
    ``quantized_bytes`` counts the uint accumulator views, ``fp_bytes``
    the float leaves; buffers are counted once per distinct tensor.
    ``effective_bits`` maps each quantized leaf's path to its served
    precision. A :class:`~repro_torch.core.plane_store.ShardedLeaf` counts
    as one leaf with the bytes of all its shards."""
    n_q = n_fp = q_bytes = fp_bytes = meta_bytes = aliased = 0
    eff_bits: dict[str, int] = {}
    seen: set[int] = set()
    for path, leaf in tree_flatten_with_path(params):
        parts = leaf.parts if isinstance(leaf, ShardedLeaf) else (leaf,)
        if isinstance(parts[0], QuantizedTensor):
            n_q += 1
            if id(parts[0].q) in seen:
                aliased += 1
            for part in parts:
                if id(part.q) not in seen:
                    seen.add(id(part.q))
                    q_bytes += part.q.numel() * part.q.element_size()
                for m in (part.lo, part.hi, part.scale, part.offset, part.received_bits):
                    if m is not None:
                        meta_bytes += m.numel() * m.element_size()
            eff = parts[0].bits
            if parts[0].received_bits is not None:
                eff = int(parts[0].received_bits.max())
            eff_bits[keystr(path)] = eff
        else:
            n_fp += 1
            if id(parts[0]) in seen:
                aliased += 1
            for part in parts:
                if id(part) not in seen:
                    seen.add(id(part))
                    fp_bytes += part.numel() * part.element_size()
    return {"quantized_leaves": n_q, "fp_leaves": n_fp,
            "quantized_bytes": q_bytes, "fp_bytes": fp_bytes,
            "metadata_bytes": meta_bytes, "aliased_leaves": aliased,
            "effective_bits": eff_bits}


class WireStoreReceiver:
    """A wire-fed :class:`~repro_torch.transmission.client.ProgressiveClient`
    as a server's parameter source: the store the byte stream fills is the
    one the server decodes from, with no second ingest.

    The views cover completed stages only: the client ORs a stage's planes
    when the stage completes, so the served parameters are exactly a
    stage prefix."""

    def __init__(self, client, prog: ProgressiveModel):
        self.client = client
        self.prog = prog

    @property
    def stages_complete(self) -> int:
        return self.client.stages_complete

    @property
    def store(self):
        return self.client.store

    def transport_health(self) -> dict:
        """The client's fault-tolerance counters (inert zeros on a trusted
        v1/v2 stream). ``stages_complete`` counts verified checkpoints
        only, so while a damaged unit is re-fetched the engine serves at
        the last verified stage."""
        c = self.client
        return {
            "integrity": c.integrity,
            "stages_complete": c.stages_complete,
            "verified_units": c.verified_units,
            "pending_nacks": len(c.nacks),
            "quarantined": len(c.quarantine_log),
            "duplicate_units": c.duplicate_units,
            "resume_cursor": list(c.resume_cursor),
        }

    def materialize(self):
        """Float parameters of the completed stages: read from the store
        without flushing the client's partial-stage planes."""
        if self.client.store is None:
            raise RuntimeError("wire header not received yet")
        leaves = self.client.store.materialize_leaves()
        return rebuild_params(self.prog, leaves, key_fn=wire.path_str)

    def materialize_resident(self, eligible=quantized_resident_eligible, *, bits=None):
        """Quantized-resident view over the client's store: weight leaves
        stay QuantizedTensor views of the accumulators, keyed by path
        string (``wire.path_str``)."""
        if self.client.store is None:
            raise RuntimeError("wire header not received yet")
        leaves = self.client.store.quantized_leaves(eligible=eligible, bits=bits)
        return rebuild_params(self.prog, leaves, key_fn=wire.path_str)


class PrecisionManagedEngine:
    """Shared precision machinery: the plane accumulators (its own
    ReceiverState in pull mode, or a receiver's store) and the
    residency-aware parameter refresh."""

    def __init__(self, model: Model, prog: ProgressiveModel, max_len: int,
                 receiver: WireStoreReceiver | None = None,
                 resident: str = "fp", *, mesh=None, device="cuda"):
        if resident not in RESIDENT_MODES:
            raise ValueError(f"resident must be one of {RESIDENT_MODES}, got {resident!r}")
        self.model = model
        self.prog = prog
        self.max_len = max_len
        self.resident = resident
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None else home_device(mesh, device)
        self._receiver = receiver
        self.state = (None if receiver is not None
                      else ReceiverState.init(prog, mesh=mesh, device=self.device))
        self._consumed = 0  # receiver mode: stages reflected in params
        self.params = None  # live parameter tree at the current precision
        self._last_upgrade_split: dict[str, float] = {}

    @property
    def stage(self) -> int:
        if self._receiver is not None:
            return self._consumed
        return self.state.received_stages

    @property
    def stages_available(self) -> int:
        """Stages the engine could upgrade to right now: every stage of
        ``self.prog`` in pull mode, the completed ones with a receiver."""
        if self._receiver is not None:
            return self._receiver.stages_complete
        return self.prog.n_stages

    def _wait(self) -> None:
        """Wait for the work queued on the engine's card (nothing on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_receiver_device(self) -> None:
        store = self._receiver.store
        if store is not None and store.device != self.device:
            raise ValueError(f"the receiver's store lies on {store.device}, the engine "
                             f"on {self.device}")
        if store is not None and getattr(store, "mesh", None) != self.mesh:
            raise ValueError("the receiver's store and the engine are on different meshes")

    def _materialize(self, bits: int | None = None):
        """The quantized-resident parameter tree over the engine's store;
        ``bits`` gives the truncated-precision views
        (``PlaneStore.quantized_leaves``)."""
        if self._receiver is None:
            return self.state.materialize_resident(quantized_resident_eligible, bits=bits)
        self._check_receiver_device()
        return self._receiver.materialize_resident(bits=bits)

    def _refresh_params(self) -> None:
        """The live parameter tree at the engine's residency: views of the
        accumulators, or float leaves of which only the tensors an ingest
        touched are dequantized again."""
        if self.resident == "quantized":
            self.params = self._materialize()
        elif self._receiver is None:
            self.params = self.state.materialize()
        else:
            self._check_receiver_device()
            self.params = self._receiver.materialize()

    def resident_report(self) -> dict:
        """Leaf-type audit of the live params (see :func:`resident_report`).
        On a mesh it adds ``gathered_bytes``: the store's copies on the
        home device beside its accumulators
        (``ShardedPlaneStore.gathered_bytes``)."""
        if self.params is None:
            raise RuntimeError("no planes received yet")
        report = resident_report(self.params)
        if self.mesh is not None:
            store = self.state.store if self._receiver is None else self._receiver.store
            report["gathered_bytes"] = store.gathered_bytes()
        return report

    def receive_stage(self) -> None:
        """Pull the next stage's planes from ``self.prog`` and OR them into
        the accumulators (one ``plane_or_segments`` launch per container
        dtype), or, with a receiver, catch up to every stage it has
        completed (its client ORed them already); then refresh the
        parameters: with ``resident="quantized"`` new accumulator views
        and new scale/offset values, no weight dequantization; with
        ``"fp"`` the touched tensors dequantized into new float leaves.
        The host time of each half lands in ``_last_upgrade_split``."""
        t0 = time.perf_counter()
        if self._receiver is not None:
            avail = self._receiver.stages_complete
            if avail <= self._consumed:
                raise RuntimeError(f"receiver has no new stage (at {avail}, "
                                   f"served {self._consumed})")
            self._consumed = avail
        else:
            s = self.state.received_stages + 1
            self.state = self.state.receive(self.prog.stage(s))
        t1 = time.perf_counter()
        self._refresh_params()
        self._last_upgrade_split = {"ingest_s": t1 - t0,
                                    "refresh_s": time.perf_counter() - t1}
        if _obs.enabled():
            tr = _obs.get_tracer()
            tr.record("upgrade_ingest", wall_s=self._last_upgrade_split["ingest_s"],
                      stage=self.stage)
            tr.record("upgrade_refresh", wall_s=self._last_upgrade_split["refresh_s"],
                      stage=self.stage)


class ProgressiveServer(PrecisionManagedEngine):
    """Single lock-stepped request stream over the device-resident plane
    accumulators. Two feeding modes:

    * pull (default): ``receive_stage()`` ingests the next stage's planes
      from ``self.prog`` into the server's own ReceiverState;
    * receiver: with ``receiver=`` (a :class:`WireStoreReceiver` over a
      wire client) the server holds no accumulators of its own, and
      ``receive_stage()`` refreshes the views of the client's store.

    A sliding-window block's ring holds ``window`` slots (the prefill's);
    decode writes one position at a time, so it needs no margin."""

    def __init__(self, model: Model, prog: ProgressiveModel, max_len: int,
                 receiver: WireStoreReceiver | None = None, resident: str = "fp", *,
                 mesh=None, device="cuda"):
        super().__init__(model, prog, max_len, receiver=receiver, resident=resident,
                         mesh=mesh, device=device)
        self.caches = None
        self.pos = 0
        self.last_logits = None
        # ring slots beyond the window (the speculative engine's verify blocks)
        self._ring_margin = 0

    def start(self, batch: dict) -> None:
        if self.params is None:
            raise RuntimeError("no planes received yet — call receive_stage()")
        tokens = torch.as_tensor(batch["tokens"]).to(device=self.device,
                                                     dtype=torch.int64)
        # a cross-attention arch's memory input, on the server's device
        mem = self.model.cfg.memory_input(tokens.shape[1])
        inputs = ({mem[0]: torch.as_tensor(batch[mem[0]]).to(self.device)}
                  if mem is not None and mem[0] in batch else {})
        last_logits, caches = self.model.prefill(self.params, {"tokens": tokens, **inputs})
        self.caches = self.model.grow_caches(caches, self.max_len,
                                             ring_margin=self._ring_margin,
                                             pos=tokens.shape[1])
        self.pos = tokens.shape[1]
        self.last_logits = last_logits

    def decode(self, steps: int, *, stage_arrival: Callable[[int], bool] | None = None,
               sync: bool = False, dispatch_window: int = 8) -> GenerationResult:
        """Greedy-decode ``steps`` tokens; before each step, consult
        ``stage_arrival(step)``: True means the next plane landed and the
        server upgrades in place (KV cache untouched).

        Launches are asynchronous: greedy sampling chains on the device
        and the host waits for the device only every ``dispatch_window``
        steps. ``sync=True`` waits after every step."""
        if sync:
            dispatch_window = 1
        toks = []
        stage_at, upgrades, per_step = [], [], []
        window_s: list[tuple[int, float]] = []
        logits = self.last_logits
        t_start = time.perf_counter()
        ttft = None
        win_t0 = t_start
        win_steps = 0
        for i in range(steps):
            if stage_arrival and self.stage < self.prog.n_stages and stage_arrival(i):
                self.receive_stage()
                upgrades.append((i, self.stage))
            nxt = torch.argmax(logits, dim=-1)[:, None]
            logits, self.caches = self.model.decode_step(self.params, self.caches, nxt,
                                                         self.pos)
            self.pos += 1
            toks.append(nxt[:, 0])
            stage_at.append(self.stage)
            win_steps += 1
            if win_steps >= dispatch_window or i == steps - 1:
                self._wait()
                now = time.perf_counter()
                if ttft is None:
                    ttft = now - t_start
                dt = now - win_t0
                window_s.append((win_steps, dt))
                per_step.extend([dt / win_steps] * win_steps)
                if _obs.enabled():
                    _obs.get_tracer().record("decode_window", wall_s=dt, engine="single")
                win_t0 = now
                win_steps = 0
        total = time.perf_counter() - t_start
        self.last_logits = logits
        if _obs.enabled():
            reg = _obs.get_registry()
            reg.histogram("engine_ttft_s", "wall seconds to first token value").observe(
                ttft or 0.0, engine="single")
            reg.counter("engine_tokens_total", "tokens emitted by serving engines").inc(
                steps, engine="single")
        return GenerationResult(
            tokens=torch.stack(toks, dim=1) if toks else None,
            stage_at_step=stage_at, upgrades=upgrades, per_step_s=per_step,
            window_s=window_s, ttft_s=ttft or 0.0, tpot_s=total / max(steps, 1),
            mode="sync" if sync else "async")


# ---------------------------------------------------------------------------
# Continuous batching: the slot pool
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PoolRequest:
    """One serving request: a prompt and a generation budget."""

    rid: int
    prompt: Any                  # (S,) int token ids
    max_new_tokens: int
    extras: dict = dataclasses.field(default_factory=dict)
    # per-request fixed-size side inputs, each without the leading batch
    # dim: a vision arch's "vision_embeds" (vision_tokens, d_vision). An
    # encoder's "enc_input" has a prompt-derived length and is not
    # poolable (see SlotPoolEngine.__init__)


@dataclasses.dataclass
class _Slot:
    rid: int | None = None       # None = free
    dispatched: int = 0          # decode steps issued for this request
    budget: int = 0

    @property
    def free(self) -> bool:
        return self.rid is None


@dataclasses.dataclass
class PoolStepStats:
    """Host-visible outcome of a flushed dispatch window: ``upgrades``
    precision upgrades were enqueued while this window's steps were in
    flight, and enqueueing them held the host for ``upgrade_enqueue_s``."""

    steps: int
    wall_s: float
    tokens_emitted: int
    upgrades: int = 0
    upgrade_enqueue_s: float = 0.0
    prefill_ticks: int = 0  # chunked-prefill blocks advanced this window


class SlotPoolEngine(PrecisionManagedEngine):
    """Continuous-batching progressive serving.

    ``n_slots`` decode slots share one set of native ``(B, Kh, S, hd)``
    caches and one live parameter tree over the PlaneStore accumulators.
    Requests queue FIFO and are admitted into free slots mid-flight;
    admission is chunked: a prompt is staged on the host and consumed
    ``prefill_chunk`` tokens per tick by one batched ragged
    ``Model.prefill_chunk`` that writes its K/V straight into the slot's
    cache rows (free and decoding slots ride along masked). A tick runs
    before every decode step. A mid-prefill slot's device ``pos`` stays
    -1, which masks it out of the interleaved decode steps; the tick that
    holds its last prompt token installs its end position, last-row
    logits and first greedy token on the device (:func:`_chunk_step`).
    A slot's device ``pos`` is >= 0 exactly while it decodes.

    Decode is dispatched in bounded asynchronous windows: greedy tokens
    chain on the device, and the host waits once per window, in
    :meth:`flush`, where it reads the window's tokens. Neither
    :meth:`step` nor the prefill tick waits for the device: the per-slot
    state lives on the device and changes by index fills, and the tick's
    host arrays go up through pinned memory without a sync. Upgrades
    apply between windows (:meth:`upgrade_if_available`); with
    ``double_buffer`` they are only enqueued, since the store ORs into
    new buffers while queued steps read the old ones.

    With ``receiver=`` the pool serves from a wire client's store, and
    :meth:`upgrade_if_available` catches up to every stage the client has
    completed (``Session.run_serving_pool``).

    ``chunked_prefill=False`` admits at batch 1 instead
    (:meth:`_admit_batch1`): one prefill of the prompt at admission, its
    caches grown to ``max_len`` and written into the slot's rows, the
    slot decoding from the next step. With ``prefill_buckets`` (default)
    the prompt is padded to a power-of-two bucket with its padded keys
    masked (``Model.prefill(n_valid)``), so a prefill runs at one of
    O(log max_len) shapes. Nothing in it waits for the device.

    Sliding-window blocks keep rings of ``window + ring_margin`` slots;
    chunked admission raises the margin to ``prefill_chunk`` (a chunk
    writes that many rows ahead of the oldest live window entry), and
    ``prefill_buckets`` is off for them (a ring has no masked slots). A
    stale ring slot of a prior occupant stays invisible: ``ring_positions``
    gives a non-negative position only to slots the new occupant wrote.

    Recurrent blocks (``mamba2``, ``mlstm``, ``slstm``) keep a cumulative
    state a slot, which a prior occupant would leak into the next: chunked
    admission zeroes the slot's state in place
    (:meth:`_reset_recurrent_slot`), and ``prefill_buckets`` is off for
    them (a state would consume the padding).

    A vision arch (``cross`` blocks) admits at batch 1: its prefill runs
    ``vision_proj`` on the request's ``extras["vision_embeds"]`` and
    writes each ``cross`` block's memory cache into the slot's rows, so
    ``chunked_prefill=None`` falls back to batch 1 and ``True`` raises. An
    encoder-decoder arch (``enc_layers`` > 0) raises: its cross caches'
    length follows each prompt's, and the pool's caches have one length.
    ``extras`` keys and per-request shapes are checked at submit, as the
    reference checks them.

    ``mesh=`` takes every arch the pool takes: each projection runs on
    the sharded store through ``ops.sharded_dequant_matmul``, while the
    caches, the recurrent states and their per-slot zeroing stay on the
    home device. The reference's
    ``decode_cache_size``/``prefill_cache_size`` count JAX executables
    and have no counterpart: nothing is compiled here.
    """

    def __init__(self, model: Model, prog: ProgressiveModel, *, n_slots: int,
                 max_len: int, receiver=None, resident: str = "fp",
                 dispatch_window: int = 8, eos_id: int | None = None,
                 ring_margin: int = 0, chunked_prefill: bool | None = None,
                 prefill_chunk: int = 8, prefill_buckets: bool = True,
                 double_buffer: bool = True, mesh=None, device="cuda"):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        cfg = model.cfg
        if cfg.enc_layers:
            # the cross caches' length follows the prompt's (frames = seq //
            # divisor), so a request's caches do not tile into the pool's
            # one length without per-slot memory masking; the single stream
            # serves these archs
            raise NotImplementedError(
                "SlotPoolEngine does not support encoder-decoder models with "
                "prompt-derived encoder lengths (cfg.enc_layers > 0); use ProgressiveServer")
        super().__init__(model, prog, max_len, receiver=receiver, resident=resident,
                         mesh=mesh, device=device)
        # a chunk step has no memory: cross-attention archs admit at batch 1
        if chunked_prefill is None:
            chunked_prefill = not cfg.uses_cross
        elif chunked_prefill and cfg.uses_cross:
            raise NotImplementedError(
                "chunked prefill is not supported for cross-attention archs (admission "
                "must run the vision/enc encoder); use chunked_prefill=None to fall back "
                "automatically")
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk = max(1, int(prefill_chunk))
        # per-request side inputs and their shapes (no batch dim)
        mem = cfg.memory_input(0)
        self._extra_specs = dict([mem]) if mem is not None else {}
        windowed = any(attn_window(cfg, k) for k in cfg.cycle + cfg.tail)
        if self.chunked_prefill and windowed:
            # a chunk writes prefill_chunk positions ahead of the oldest
            # live window entry, as a verify block does
            ring_margin = max(ring_margin, self.prefill_chunk)
        self._ring_margin = ring_margin
        # a ring has no masked slots, and a recurrent state would consume
        # the padding
        self.prefill_buckets = bool(prefill_buckets) and not windowed \
            and not recurrent_kinds(cfg)
        self.double_buffer = bool(double_buffer)
        self.n_slots = n_slots
        self.dispatch_window = max(1, dispatch_window)
        dev = self.device
        self.caches = model.init_caches(n_slots, max_len, ring_margin=ring_margin, device=dev)
        # (part, slot key) of every recurrent block's cache
        self._recurrent_keys = [(part, f"{j}_{kind}") for part, kinds in
                                (("cycles", cfg.cycle), ("tail", cfg.tail))
                                for j, kind in enumerate(kinds)
                                if kind in RECURRENT_KINDS and f"{j}_{kind}" in self.caches[part]]
        self.pos = torch.full((n_slots,), -1, dtype=torch.int32, device=dev)
        self.last_logits = torch.zeros((n_slots, model.cfg.vocab), dtype=torch.float32,
                                       device=dev)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: list[PoolRequest] = []         # FIFO admission backlog
        self.outputs: dict[int, list[int]] = {}    # rid -> generated tokens
        self.stage_log: dict[int, list[int]] = {}  # rid -> stage per token
        self.admit_stage: dict[int, int] = {}      # rid -> prefill stage
        self.admitted_order: list[int] = []        # rids, actual admission
        self.completed: set[int] = set()
        self._retired: set[int] = set()  # evicted, final window not yet flushed
        # in-flight dispatched steps awaiting a flush:
        # (tokens (B, 1) device tensor, {slot: rid} snapshot, stage)
        self._pending: list[tuple[torch.Tensor, dict[int, int], int]] = []
        self._win_t0: float | None = None
        self.window_stats: list[PoolStepStats] = []
        self.upgrade_stall_s = 0.0     # host time blocked on upgrades
        self.upgrade_enqueue_s = 0.0   # host time enqueueing them
        self.upgrade_log: list[dict] = []           # per-upgrade record
        self.upgrades: list[tuple[int, int]] = []   # (global step, stage)
        self._step_count = 0
        self._tick_count = 0           # chunked-prefill blocks consumed
        self._win_upgrades = 0
        self._win_upgrade_enqueue_s = 0.0
        self._win_prefill_ticks = 0
        # slot -> staged prompt and consumption offset; such a slot holds
        # a request (not free) but does not decode yet
        self._prefill_state: dict[int, dict] = {}
        # device-side companions the chunk step fills when a slot's prefill
        # completes: its first greedy token, as the last-token chain that a
        # speculative draft consumes and as a capture read at flush
        self._last_tok = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        self._first_cap = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self._submit_t: dict[int, float] = {}   # rid -> submit wall time
        self.ttft_s: dict[int, float] = {}      # rid -> first-token latency
        # eos is checked at flush boundaries: a request may decode up to
        # dispatch_window - 1 tokens past its eos, which are dropped
        self.eos_id = eos_id

    # -- admission / eviction ----------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.free]

    def active_rids(self) -> dict[int, int]:
        """Slots that decode: admitted, prefill complete."""
        return {i: s.rid for i, s in enumerate(self.slots)
                if not s.free and i not in self._prefill_state}

    def submit(self, request: PoolRequest) -> None:
        """Queue a request; it is admitted into the next free slot at the
        next admission point (at once if a slot is free). A malformed
        request raises here, before any device work."""
        self._validate_request(request)
        self._submit_t[request.rid] = time.perf_counter()
        self.queue.append(request)
        self._admit_from_queue()

    def _validate_request(self, req: PoolRequest) -> None:
        """Host-side (numpy) checks, with the reference's errors."""
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1:
            raise ValueError(
                f"PoolRequest.prompt must be one-dimensional (S,), got "
                f"shape {prompt.shape}")
        if prompt.shape[0] < 1:
            raise ValueError("PoolRequest.prompt must hold >= 1 token")
        if prompt.shape[0] + req.max_new_tokens > self.max_len:
            # write positions reach prompt_len + budget - 1; past max_len
            # the cache write would clamp onto the last row
            raise ValueError(
                f"request needs {prompt.shape[0]} prompt + "
                f"{req.max_new_tokens} new tokens > max_len {self.max_len}")
        for k, v in req.extras.items():
            if k not in self._extra_specs:
                raise ValueError(f"unknown extras key {k!r}; this arch accepts "
                                 f"{sorted(self._extra_specs)}")
            got, want = tuple(np.shape(v)), self._extra_specs[k]
            if got != want:
                raise ValueError(f"extras[{k!r}] must have per-request shape {want} "
                                 f"(no batch dim), got {got}")

    def _admit_from_queue(self) -> None:
        while self.queue and (free := self.free_slots()):
            self._admit(free[0], self.queue.pop(0))

    def _admit(self, slot: int, req: PoolRequest) -> None:
        if self.params is None:
            raise RuntimeError("no planes received yet — call receive_stage()")
        prompt = np.asarray(req.prompt, np.int32)
        self.slots[slot] = _Slot(rid=req.rid, dispatched=0, budget=req.max_new_tokens)
        self.outputs.setdefault(req.rid, [])
        self.stage_log.setdefault(req.rid, [])
        self.admit_stage[req.rid] = self.stage
        self.admitted_order.append(req.rid)
        self._post_admit(slot, req, int(prompt.shape[0]))
        if self.chunked_prefill:
            self._begin_chunked_prefill(slot, req, prompt)
        else:
            self._admit_batch1(slot, req, prompt)

    def _post_admit(self, slot: int, req: PoolRequest, prompt_len: int) -> None:
        """Subclass hook, called once per admission before the prompt is
        consumed."""

    def _admit_batch1(self, slot: int, req: PoolRequest, prompt: np.ndarray) -> None:
        """Batch-1 admission: prefill the prompt alone (padded to its
        bucket with ``prefill_buckets``), grow its caches to ``max_len``
        and write them into the slot's rows; the slot's end position and
        last-row logits go in on the device. The prompt and the request's
        ``extras`` (with a leading axis of 1) go up through pinned memory
        and every write is a device copy, so nothing waits."""
        L = int(prompt.shape[0])
        tokens = prompt[None, :]
        n_valid = None
        if self.prefill_buckets:
            bucket = min(max(1 << (L - 1).bit_length(), 1), self.max_len)
            if bucket > L:
                tokens = np.pad(tokens, ((0, 0), (0, bucket - L)))
            n_valid = np.asarray([L], np.int32)
        batch = {"tokens": to_device(tokens.astype(np.int32), self.device)}
        for k, v in req.extras.items():
            # a tensor as it lies (on the card or not), an array through pinned memory
            batch[k] = (v.to(self.device, non_blocking=True) if isinstance(v, torch.Tensor)
                        else to_device(np.asarray(v), self.device))[None]
        if n_valid is not None:
            n_valid = to_device(n_valid, self.device)
        last_logits, caches = self.model.prefill(self.params, batch, n_valid)
        caches = self._grow_admitted(caches, L)
        self.caches = _write_slot_tree(self.caches, caches, slot, self.n_slots)
        self.pos[slot:slot + 1].fill_(L)
        self.last_logits[slot:slot + 1].copy_(last_logits)
        self._post_admit_batch1(slot, req, last_logits, L)

    def _grow_admitted(self, caches, prompt_len: int):
        """A batch-1 prefill's caches grown to the pool's length, its rings
        (``window`` slots) repacked into the pool's ``window + ring_margin``."""
        return self.model.grow_caches(caches, self.max_len, ring_margin=self._ring_margin,
                                      pos=prompt_len)

    def _post_admit_batch1(self, slot: int, req: PoolRequest, last_logits,
                           prompt_len: int) -> None:
        """Subclass hook after a batch-1 admission's device writes."""

    def _begin_chunked_prefill(self, slot: int, req: PoolRequest,
                               prompt: np.ndarray) -> None:
        """Stage the prompt for :meth:`_prefill_tick`. A prior occupant's
        stale KV rows need no reset: the causal mask hides every row past a
        query's position, and a row is written before any query reaches
        it. A recurrent state is cumulative, not positional, so it is
        zeroed (:meth:`_reset_recurrent_slot`)."""
        self._reset_recurrent_slot(slot)
        self._prefill_state[slot] = {"prompt": prompt, "off": 0, "rid": req.rid,
                                     "len": int(prompt.shape[0])}

    def _reset_recurrent_slot(self, slot: int) -> None:
        """Zero one slot's recurrent state, in place on the device: a fill
        of the slot's rows of each leaf (batch axis 1 of a stacked slot, 0
        of a tail block), nothing read back, nothing cache-sized copied."""
        for part, key in self._recurrent_keys:
            for leaf in self.caches[part][key].values():
                (leaf[:, slot] if part == "cycles" else leaf[slot]).zero_()

    def _prefill_tick(self) -> None:
        """Advance every mid-prefill slot by one (B, chunk) block in one
        batched ``prefill_chunk``; free and decoding slots ride along
        masked (tok_pos = -1). A slot whose last prompt token is in this
        block gets its end position, last-row logits and first greedy
        token installed on the device, so it joins the next decode step
        with no host sync."""
        if not self._prefill_state:
            return
        C, B = self.prefill_chunk, self.n_slots
        # one int32 buffer, one asynchronous copy: tokens (B, C),
        # positions (B, C), final row (B,)
        host = np.zeros((B, 2 * C + 1), np.int32)
        host[:, C:] = -1
        done: list[int] = []
        for slot, st in self._prefill_state.items():
            off, L = st["off"], st["len"]
            if off == 0:
                # the stage the prompt is consumed at: an upgrade may land
                # between submit and the first tick
                self.admit_stage[st["rid"]] = self.stage
            n = min(C, L - off)
            host[slot, :n] = st["prompt"][off:off + n]
            host[slot, C:C + n] = np.arange(off, off + n, dtype=np.int32)
            if off + n == L:
                host[slot, 2 * C] = n - 1
                done.append(slot)
            st["off"] = off + n
        staged = to_device(host, self.device)
        (self.caches, self.pos, self.last_logits, self._last_tok,
         self._first_cap) = _chunk_step(
            self.model, self.params, self.caches, staged[:, :C], staged[:, C:2 * C],
            staged[:, 2 * C], self.pos, self.last_logits, self._last_tok,
            self._first_cap)
        self._tick_count += 1
        self._win_prefill_ticks += 1
        for slot in done:
            del self._prefill_state[slot]
            self._on_prefill_complete(slot)

    def _on_prefill_complete(self, slot: int) -> None:
        """Subclass hook when a slot's chunked prefill finishes."""

    def _note_first_token(self, rid: int) -> None:
        t = self._submit_t.get(rid)
        if t is not None and rid not in self.ttft_s:
            self.ttft_s[rid] = time.perf_counter() - t
            if _obs.enabled():
                _obs.get_registry().histogram(
                    "engine_ttft_s", "wall seconds to first token value").observe(
                        self.ttft_s[rid], engine=type(self).__name__)

    def _evict(self, slot: int) -> int:
        rid = self.slots[slot].rid
        self.slots[slot] = _Slot()
        self.pos[slot:slot + 1].fill_(-1)   # a fill: no copy, no sync
        self._retired.add(rid)         # completed once its last window flushes
        return rid

    # -- batched ragged decode ---------------------------------------------
    def step(self) -> dict[int, int]:
        """One scheduling tick: advance chunked prefills by one block (if
        any are staged), then dispatch one batched decode step for every
        decoding slot (free and mid-prefill slots ride along masked).
        Returns the ``{slot: rid}`` snapshot the decode step ran for,
        empty when nothing decodes yet. Nothing here waits for the
        device."""
        if self.params is None:
            raise RuntimeError("no planes received yet — call receive_stage()")
        if self._win_t0 is None:
            self._win_t0 = time.perf_counter()
        self._prefill_tick()
        snapshot = self.active_rids()
        if not snapshot:
            return snapshot
        nxt = torch.argmax(self.last_logits, dim=-1).to(torch.int32)[:, None]
        logits, self.caches = self.model.decode_step(self.params, self.caches, nxt,
                                                     self.pos)
        # the decoding slots are exactly those with pos >= 0
        self.pos = torch.where(self.pos >= 0, self.pos + 1, self.pos)
        self.last_logits = logits
        self._pending.append((nxt, snapshot, self.stage))
        self._step_count += 1
        # dispatch-time bookkeeping: budgets count down without reading
        # token values, so length-complete slots free at once
        for slot in snapshot:
            s = self.slots[slot]
            s.dispatched += 1
            if s.dispatched >= s.budget:
                self._evict(slot)
        return snapshot

    def flush(self) -> PoolStepStats | None:
        """Wait for the in-flight window, hand its token values to their
        requests, complete eos- and budget-finished ones."""
        if not self._pending:
            return None
        # the window's one host sync: the copy queues behind every step
        toks = torch.cat([t for t, _, _ in self._pending], dim=1).cpu().numpy()
        wall = time.perf_counter() - (self._win_t0 or time.perf_counter())
        emitted = 0
        eos_hit: set[int] = set()
        for j, (_, snapshot, stage) in enumerate(self._pending):
            for slot, rid in snapshot.items():
                if rid in eos_hit:
                    continue
                tok = int(toks[slot, j])
                if not self.outputs[rid]:
                    self._note_first_token(rid)
                self.outputs[rid].append(tok)
                self.stage_log[rid].append(stage)
                emitted += 1
                if self.eos_id is not None and tok == self.eos_id:
                    eos_hit.add(rid)
                    # the slot may already be freed by budget bookkeeping
                    if not self.slots[slot].free and self.slots[slot].rid == rid:
                        self._evict(slot)
        self.completed |= self._retired
        self._retired.clear()
        stats = PoolStepStats(steps=len(self._pending), wall_s=wall,
                              tokens_emitted=emitted, upgrades=self._win_upgrades,
                              upgrade_enqueue_s=self._win_upgrade_enqueue_s,
                              prefill_ticks=self._win_prefill_ticks)
        return self._record_window(stats)

    def _record_window(self, stats: PoolStepStats) -> PoolStepStats:
        """Window chokepoint, shared with the speculative pool: append the
        stats, reset the window's accumulators, mirror the stats into the
        telemetry registry."""
        self.window_stats.append(stats)
        self._pending.clear()
        self._win_t0 = None
        self._win_upgrades = 0
        self._win_upgrade_enqueue_s = 0.0
        self._win_prefill_ticks = 0
        if _obs.enabled():
            engine = type(self).__name__
            reg = _obs.get_registry()
            reg.counter("engine_tokens_total", "tokens emitted by serving engines").inc(
                stats.tokens_emitted, engine=engine)
            reg.counter("engine_prefill_ticks_total", "chunked prefill ticks").inc(
                stats.prefill_ticks, engine=engine)
            reg.histogram("engine_window_steps", "decode steps per flushed window").observe(
                stats.steps, engine=engine)
            _obs.get_tracer().record("decode_window", wall_s=stats.wall_s, engine=engine)
        return stats

    def upgrade_if_available(self) -> bool:
        """Apply newly arrived precision: with a receiver, catch up to
        every stage its client has completed; in pull mode advance one
        stage (the caller models the arrival cadence). With ``double_buffer`` (default) this only enqueues the
        OR and the view refresh: the store writes new accumulators while
        queued decode steps read the old ones, and the next dispatched
        step reads the new ones in stream order. ``double_buffer=False``
        waits for the device after the upgrade, for A/B stall
        measurement. ``upgrade_log`` records each upgrade's host times."""
        if self.stage >= self.prog.n_stages or self.stages_available <= self.stage:
            return False
        t0 = time.perf_counter()
        self.receive_stage()
        enqueue_s = time.perf_counter() - t0
        if not self.double_buffer:
            self._wait()
        stall_s = time.perf_counter() - t0
        self.upgrade_enqueue_s += enqueue_s
        self.upgrade_stall_s += stall_s
        self._win_upgrades += 1
        self._win_upgrade_enqueue_s += enqueue_s
        split = self._last_upgrade_split
        self._record_upgrade({
            "step": self._step_count, "stage": self.stage,
            "enqueue_s": enqueue_s, "stall_s": stall_s,
            "ingest_s": split.get("ingest_s", 0.0),
            "refresh_s": split.get("refresh_s", 0.0),
            "fence_s": stall_s - enqueue_s,
            "sharded": self.mesh is not None, "double_buffer": self.double_buffer})
        self.upgrades.append((self._step_count, self.stage))
        return True

    def _record_upgrade(self, rec: dict) -> None:
        """Upgrade chokepoint: the ``upgrade_log`` record, and the
        registry's counter and histograms over the same values."""
        self.upgrade_log.append(rec)
        if _obs.enabled():
            engine = type(self).__name__
            reg = _obs.get_registry()
            reg.counter("engine_upgrades_total", "precision upgrades applied").inc(
                engine=engine, stage=rec["stage"])
            reg.histogram("engine_upgrade_enqueue_s", "host enqueue seconds per upgrade"
                          ).observe(rec["enqueue_s"], engine=engine)
            reg.histogram("engine_upgrade_stall_s", "host-blocked seconds per upgrade"
                          ).observe(rec["stall_s"], engine=engine)

    def run(self, *, max_steps: int = 100_000,
            on_window: Callable[[int], None] | None = None) -> dict[int, list[int]]:
        """Drive the pool until every submitted request completes.
        ``on_window(step_count)`` runs at every window boundary (to admit
        staggered arrivals or upgrade)."""
        while any(not s.free for s in self.slots) or self.queue:
            for _ in range(self.dispatch_window):
                if not any(not s.free for s in self.slots):
                    break
                self.step()
                if self._step_count >= max_steps:
                    break
            self.flush()
            self._admit_from_queue()
            if on_window is not None:
                on_window(self._step_count)
            if self._step_count >= max_steps:
                break
        self.flush()
        return {rid: list(v) for rid, v in self.outputs.items()}


def _chunk_step(model: Model, params, caches, tokens, tok_pos, final_row, pos,
                last_logits, last_tok, first_cap):
    """Consume one (B, C) prompt block into the pooled caches and, for each
    slot whose last prompt token is in it (``final_row[b] >= 0`` is that
    row), hand off on the device: end position, last-row logits and the
    argmax first token (into the last-token chain and the first-token
    capture). Other slots pass through untouched. No host sync."""
    logits, caches = model.prefill_chunk(params, caches, tokens, tok_pos)
    B, C = tokens.shape
    slots = torch.arange(B, device=logits.device)
    row = torch.clamp(final_row, 0, C - 1).long()
    sel = logits[slots, row]                                   # (B, V)
    done = final_row >= 0
    last_logits = torch.where(done[:, None], sel.to(last_logits.dtype), last_logits)
    pos = torch.where(done, tok_pos[slots, row] + 1, pos)
    first = torch.argmax(sel, dim=-1).to(torch.int32)
    last_tok = torch.where(done[:, None], first[:, None], last_tok)
    first_cap = torch.where(done, first, first_cap)
    return caches, pos, last_logits, last_tok, first_cap


def _write_slot_tree(pool, one, slot: int, n_slots: int):
    """Write a batch-1 cache tree into batch row ``slot`` of the pool's
    cache tree, in place; returns ``pool``. Each leaf's batch axis is the
    one axis where the pool leaf is ``n_slots`` wide and the request's
    leaf 1 wide (leaves of equal shapes, ``n_slots == 1``, are copied
    whole)."""
    if isinstance(pool, dict):
        return {k: _write_slot_tree(pool[k], one[k], slot, n_slots) for k in pool}
    if pool.shape == one.shape:
        return pool.copy_(one)
    cand = [d for d, (a, b) in enumerate(zip(pool.shape, one.shape)) if a != b]
    if len(cand) != 1 or one.shape[cand[0]] != 1 or pool.shape[cand[0]] != n_slots:
        raise ValueError(f"cannot locate batch axis: pool {tuple(pool.shape)} vs one "
                         f"{tuple(one.shape)}")
    pool.narrow(cand[0], slot, 1).copy_(one)
    return pool
