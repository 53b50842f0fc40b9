"""Progressive serving: a server starts with the MSB planes of the
weights, serves at once, and upgrades precision in place between decode
steps as later planes arrive. The KV cache survives every upgrade.

Counterpart of ``src/repro/serving/engine.py`` for the pull-mode
single-stream server with ``resident="quantized"``: the live parameter
tree holds :class:`~repro_torch.core.quantize.QuantizedTensor` views of
the PlaneStore accumulators, eq. (5) runs inside every matmul
(``kernels/dequant_matmul``) and no float weight buffer exists. An
upgrade is one ``plane_or_segments`` launch per container dtype plus new
scale/offset values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import resolve_device
from repro_torch.core.progressive import (ProgressiveModel, ReceiverState,
                                          tree_flatten_with_path)
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.models.common import quantized_resident_eligible
from repro_torch.models.model import Model

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
    precision."""
    n_q = n_fp = q_bytes = fp_bytes = meta_bytes = aliased = 0
    eff_bits: dict[str, int] = {}
    seen: set[int] = set()
    for path, leaf in tree_flatten_with_path(params):
        if isinstance(leaf, QuantizedTensor):
            n_q += 1
            if id(leaf.q) in seen:
                aliased += 1
            else:
                seen.add(id(leaf.q))
                q_bytes += leaf.q.numel() * leaf.q.element_size()
            for m in (leaf.lo, leaf.hi, leaf.scale, leaf.offset, leaf.received_bits):
                if m is not None:
                    meta_bytes += m.numel() * m.element_size()
            eff = leaf.bits
            if leaf.received_bits is not None:
                eff = int(leaf.received_bits.max())
            eff_bits[keystr(path)] = eff
        else:
            n_fp += 1
            if id(leaf) in seen:
                aliased += 1
            else:
                seen.add(id(leaf))
                fp_bytes += leaf.numel() * leaf.element_size()
    return {"quantized_leaves": n_q, "fp_leaves": n_fp,
            "quantized_bytes": q_bytes, "fp_bytes": fp_bytes,
            "metadata_bytes": meta_bytes, "aliased_leaves": aliased,
            "effective_bits": eff_bits}


class PrecisionManagedEngine:
    """Shared precision machinery: the plane accumulators (its own
    ReceiverState, pull mode) and the residency-aware parameter refresh.

    ``resident="fp"`` (a float copy of the model refreshed at each
    upgrade) is still to be ported (ROADMAP A6); only
    ``resident="quantized"`` runs."""

    def __init__(self, model: Model, prog: ProgressiveModel, max_len: int,
                 resident: str = "fp", *, device="cuda"):
        if resident not in RESIDENT_MODES:
            raise ValueError(f"resident must be one of {RESIDENT_MODES}, got {resident!r}")
        if resident == "fp":
            raise NotImplementedError(
                "resident='fp' is still to be ported (ROADMAP A6: resident='fp' "
                "with batched dequant); pass resident='quantized'")
        self.model = model
        self.prog = prog
        self.max_len = max_len
        self.resident = resident
        self.device = resolve_device(device)
        self.state = ReceiverState.init(prog, device=self.device)
        self.params = None  # live parameter tree at the current precision

    @property
    def stage(self) -> int:
        return self.state.received_stages

    def _refresh_params(self) -> None:
        self.params = self.state.materialize_resident(quantized_resident_eligible)

    def resident_report(self) -> dict:
        """Leaf-type audit of the live params (see :func:`resident_report`)."""
        if self.params is None:
            raise RuntimeError("no planes received yet")
        return resident_report(self.params)

    def receive_stage(self) -> None:
        """Pull the next stage's planes from ``self.prog`` and OR them into
        the accumulators (one ``plane_or_segments`` launch per container
        dtype), then refresh the parameter views: new accumulator views
        and new scale/offset values, no weight dequantization."""
        s = self.state.received_stages + 1
        self.state = self.state.receive(self.prog.stage(s))
        self._refresh_params()


class ProgressiveServer(PrecisionManagedEngine):
    """Single lock-stepped request stream over the device-resident plane
    accumulators. Pull mode: ``receive_stage()`` ingests the next stage's
    planes from ``self.prog``."""

    def __init__(self, model: Model, prog: ProgressiveModel, max_len: int,
                 resident: str = "fp", *, device="cuda"):
        super().__init__(model, prog, max_len, resident=resident, device=device)
        self.caches = None
        self.pos = 0
        self.last_logits = None

    def start(self, batch: dict) -> None:
        if self.params is None:
            raise RuntimeError("no planes received yet — call receive_stage()")
        tokens = torch.as_tensor(batch["tokens"]).to(device=self.device,
                                                     dtype=torch.int64)
        last_logits, caches = self.model.prefill(self.params, {"tokens": tokens})
        self.caches = self.model.grow_caches(caches, self.max_len)
        self.pos = tokens.shape[1]
        self.last_logits = last_logits

    def _wait(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
                win_t0 = now
                win_steps = 0
        total = time.perf_counter() - t_start
        self.last_logits = logits
        return GenerationResult(
            tokens=torch.stack(toks, dim=1) if toks else None,
            stage_at_step=stage_at, upgrades=upgrades, per_step_s=per_step,
            window_s=window_s, ttft_s=ttft or 0.0, tpot_s=total / max(steps, 1),
            mode="sync" if sync else "async")
