"""Self-speculative progressive decoding: the precision ladder as a draft
model.

Counterpart of ``src/repro/serving/speculative.py``. Every prefix of the
transmitted planes is itself a working model, so a truncated-precision
view of the SAME PlaneStore accumulators
(``PlaneStore.quantized_leaves(bits=b)``: a deferred plane mask and a
recomputed eq.-(5) offset, sharing every uint buffer with the target
view) drafts k greedy tokens at zero extra bytes, and the view at the
received precision verifies the whole draft in one pass
(``Model.verify_step``). The output is plain greedy decoding, token for
token, at every precision stage.

Speculation round (per slot; batched and ragged across slots)::

    last --draft--> d1..dk        (k decode_steps on the draft view,
      |                            draft K/V written in place)
      +--[last,d1..dk]--verify--> g0..gk = target greedy per row
                                  (one verify_step; target K/V
                                   overwrites the draft's rows)
    accept a = longest prefix with d_{t+1} == g_t
    emit g0..ga   (a accepted drafts + 1 correction/bonus token)
    the next round feeds g_a at pos + a + 1; rejected rows are never
    rolled back, later rounds overwrite them

Why the output is exact on the card: ``verify_step`` and ``decode_step``
run every dense layer on the route whose rows do not depend on M
(``rows="decode"``), the norms take their statistics row by row in one
thread layout, and every ``flash_verify`` row equals a ``flash_decode``
launch; so a verify row's logits and K/V equal the decode step of its
token bit for bit, and accepted drafts plus the correction token ARE the
plain greedy stream. Both views are masked forms of one store: the
target with a full-width keep (a value no-op), the draft with
``draft_bits``, both as int32 device tensors, so switching views or
moving ``draft_bits`` changes no launch argument.

The host reads each round's greedy tokens and acceptance counts once (the
single stream per round, the pool once per window); argmax, the
cumulative product of matches and the gather of the next token stay on
the device.

Both serving shapes: :class:`SpeculativeEngine`, the lock-stepped single
stream whose slots go ragged after the prompt, and
:class:`SpeculativeSlotPool`, continuous batching where admissions,
evictions and upgrades interleave with rounds.

Sliding-window rings are grown by ``k_max + 1`` slots in both engines
(after the prefill, and at the pool's construction), so a verify block's
rows never land on a position still inside a live window; a draft step
and the verify row at the same position see the same ring in the same
slot order, so speculative tokens stay plain greedy tokens.

Left for later, raising ``NotImplementedError`` naming its ROADMAP item:
the reference's telemetry counters of each accept round (A11;
``accept_log`` is kept). The reference's
``decode_cache_size`` counts JAX executables and has no counterpart
until the port captures CUDA graphs, as for the plain engines.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import to_device
from repro_torch.core.policy import SpeculationController
from repro_torch.serving.engine import (PoolStepStats, ProgressiveServer, SlotPoolEngine,
                                        _later, resident_report)


@dataclasses.dataclass
class SpecConfig:
    """How to speculate. ``k=None`` hands the draft length to an adaptive
    :class:`~repro_torch.core.policy.SpeculationController` (k moves on a
    power-of-two ladder with the acceptance rate and is 0 while the
    download has not passed ``draft_bits``); an integer pins it."""

    draft_bits: int = 4
    k: int | None = None
    k_max: int = 8

    def __post_init__(self):
        if self.k is not None and self.k < 0:
            raise ValueError(f"k must be >= 0, got {self.k}")
        if self.k is not None and self.k > self.k_max:
            # k_max sizes the verify headroom, so it must cover k
            self.k_max = self.k

    def make_controller(self) -> SpeculationController:
        k0 = self.k if self.k is not None else min(4, self.k_max)
        return SpeculationController(draft_bits=self.draft_bits, k_max=self.k_max,
                                     k_init=max(k0, 1))


@dataclasses.dataclass
class SpeculativeResult:
    """Outcome of a speculative generation. ``tokens`` is the plain greedy
    stream (B, steps), int64 on the host; speculation's record rides
    alongside."""

    tokens: Any
    stage_log: list          # per slot: stage at each emitted token
    upgrades: list           # (min emitted tokens, new stage)
    accept_rounds: list      # per round: dict(k, accepted, rate, stage)
    rounds: int = 0
    drafted: int = 0         # draft tokens proposed (active slots only)
    accepted: int = 0        # draft tokens accepted
    wall_s: float = 0.0
    ttft_s: float = 0.0

    @property
    def stage_at_step(self):
        """Slot 0's stage log, the plain path's lock-step view."""
        return self.stage_log[0] if self.stage_log else []

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 0.0


def _verify_and_accept(model, params, caches, tokens: torch.Tensor, pos: torch.Tensor):
    """One target verify pass and the acceptance, on the device.

    tokens: (B, T) int32 = last accepted token ++ k drafts; pos: (B,) base
    positions (negative = inactive slot). Returns ``(g, acc, nxt,
    caches)``: ``g[:, t]`` is the target's greedy token after
    ``tokens[:, :t+1]``, ``acc`` the per-slot count of accepted drafts
    (longest matching prefix) and ``nxt = g[:, acc]`` the token that seeds
    the next round."""
    logits, caches = model.verify_step(params, caches, tokens, pos)
    g = torch.argmax(logits, dim=-1).to(torch.int32)                   # (B, T)
    if tokens.shape[1] > 1:
        match = (tokens[:, 1:] == g[:, :-1]).to(torch.int32)           # (B, k)
        acc = torch.cumprod(match, dim=1).sum(dim=1, dtype=torch.int32)
    else:
        acc = torch.zeros(tokens.shape[:1], dtype=torch.int32, device=tokens.device)
    nxt = torch.gather(g, 1, acc[:, None].long())                       # (B, 1)
    return g, acc, nxt, caches


class _SpeculativeMixin:
    """Draft-view plumbing shared by the single stream and the pool: both
    precision views from ONE store, the round protocol, the audits."""

    _SSM_KINDS = frozenset({"mamba2", "mlstm", "slstm"})
    # The target view is built in masked form too (bits clamped per leaf
    # to its width: a value no-op), so a k = 0 round runs it through the
    # same decode_step the draft uses.
    _FULL_BITS = 1 << 10

    def _init_spec(self, spec: SpecConfig | None) -> None:
        cfg = self.model.cfg
        ssm = set(cfg.cycle + cfg.tail) & self._SSM_KINDS
        if ssm:
            raise NotImplementedError(
                f"speculative decoding is not supported for recurrent blocks "
                f"{sorted(ssm)}: their cumulative state has no overwrite-only "
                f"rollback (a rejected draft would need a state snapshot per token)")
        if os.environ.get("REPRO_TELEMETRY", "") not in ("", "0"):
            raise _later("the speculative engines' telemetry (the reference's counters "
                         "of each accept round)", "A11")
        self.spec = spec or SpecConfig()
        # The verify block writes T = k + 1 rows from the base position and
        # the cache write clamps at the cache end: without k_max + 1 rows
        # of headroom past the last position it would overwrite live rows.
        min_len = self.spec.k_max + 2
        if self.max_len < min_len:
            raise ValueError(
                f"max_len {self.max_len} < k_max + 2 = {min_len}: the T-wide verify "
                f"write needs k_max + 1 rows of headroom past the base position, or "
                f"it clamps onto live KV rows")
        self.controller = self.spec.make_controller()
        self.draft_params = None
        self.accept_log: list[dict] = []
        if self.params is not None:
            self._refresh_params()

    # -- both views, one store --------------------------------------------
    def current_draft_bits(self) -> int:
        """Fixed-k engines pin the draft precision; adaptive ones follow the
        controller."""
        return (self.spec.draft_bits if self.spec.k is not None
                else self.controller.draft_bits)

    def _refresh_params(self) -> None:
        self._draft_bits_live = self.current_draft_bits()
        self.params = self._materialize(self._FULL_BITS)
        self.draft_params = self._materialize(self._draft_bits_live)

    def _sync_draft_view(self) -> None:
        """Re-point the draft view when the controller moved draft_bits:
        new views of the same accumulators."""
        if self.current_draft_bits() != getattr(self, "_draft_bits_live", None):
            self._refresh_params()

    def receive_stage(self) -> None:
        """An upgrade changes the draft/target gap, so the controller's
        acceptance evidence is stale: relax it toward its prior."""
        super().receive_stage()
        self.controller.on_upgrade()

    def received_bits_now(self) -> int:
        """Least effective precision over the store's tensors: what the
        controller compares with draft_bits."""
        store = self._receiver.store if self._receiver is not None else self.state.store
        if store is None or store.n_tensors == 0:
            return 0
        return min(store.effective_bits(i) for i in range(store.n_tensors))

    def choose_k(self) -> int:
        if self.spec.k is not None:
            if self.received_bits_now() <= self.spec.draft_bits:
                return 0   # no precision gap: drafting buys nothing
            return min(self.spec.k, self.spec.k_max)
        return self.controller.choose_k(self.received_bits_now())

    # -- one round, shared by both serving shapes ---------------------------
    def _run_round(self, caches, last_tok: torch.Tensor, pos: torch.Tensor, k_eff: int):
        """Draft k_eff tokens on the truncated view, then verify the block
        on the target view; with k_eff == 0, one plain decode step on the
        target view. Draft step j feeds block token j at pos + j, and the
        verify overwrites every drafted row with target K/V. Returns
        ``(g, acc, nxt, caches)``, all on the device."""
        model = self.model
        if k_eff == 0:
            logits, caches = model.decode_step(self.params, caches, last_tok, pos)
            g = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            return g, torch.zeros(g.shape[:1], dtype=torch.int32, device=g.device), g, caches
        toks, cur = [last_tok], last_tok
        for j in range(k_eff):
            # inactive slots keep a negative position: -1 + j would walk
            # back into range and write their cache rows
            pj = torch.where(pos >= 0, pos + j, -1)
            logits, caches = model.decode_step(self.draft_params, caches, cur, pj)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
            toks.append(cur)
        return _verify_and_accept(model, self.params, caches, torch.cat(toks, dim=1), pos)

    # -- audits --------------------------------------------------------------
    def resident_report(self) -> dict:
        """Target and draft views audited together: the draft shares every
        weight buffer with the target (``aliased_leaves``), so
        ``extra_draft_bytes``, the resident weight bytes beyond the target
        view alone, is 0; ``effective_bits`` tells the views apart."""
        if self.params is None or self.draft_params is None:
            raise RuntimeError("no planes received yet")
        target = resident_report(self.params)
        both = resident_report({"target": self.params, "draft": self.draft_params})
        both["extra_draft_bytes"] = (both["quantized_bytes"] + both["fp_bytes"]
                                     - target["quantized_bytes"] - target["fp_bytes"])
        return both


class SpeculativeEngine(_SpeculativeMixin, ProgressiveServer):
    """Single-stream self-speculative server (quantized-resident only: the
    draft is a second view over the resident accumulators).

    Slots start lock-stepped at the prompt and go ragged at once: each
    accepts a different number of drafts a round, so positions are
    per-slot ``(B,)`` from the first round. A slot that has emitted
    ``steps`` tokens is masked out (``pos = -1``) while the rest finish."""

    def __init__(self, model, prog, max_len: int, receiver=None,
                 spec: SpecConfig | None = None, mesh=None, *, device="cuda"):
        super().__init__(model, prog, max_len, receiver=receiver, resident="quantized",
                         mesh=mesh, device=device)
        self._init_spec(spec)
        # the prefill's rings grow by the largest verify block
        self._ring_margin = self.spec.k_max + 1

    def start(self, batch: dict) -> None:
        if self.params is None:
            raise RuntimeError("no planes received yet — call receive_stage()")
        prompt_len = int(np.shape(batch["tokens"])[1])
        if prompt_len + self.spec.k_max + 1 > self.max_len:
            raise ValueError(
                f"prompt of {prompt_len} tokens leaves no verify headroom: needs "
                f"prompt + k_max + 1 = {prompt_len + self.spec.k_max + 1} <= max_len "
                f"{self.max_len}")
        super().start(batch)
        self._pos_np = np.full((self.last_logits.shape[0],), prompt_len, np.int64)
        self._first_tok = torch.argmax(self.last_logits, dim=-1).to(torch.int32)[:, None]
        self._decoded = False

    def decode(self, steps: int, *, stage_arrival: Callable[[int], bool] | None = None,
               on_round: Callable[[dict], None] | None = None,
               **_ignored) -> SpeculativeResult:
        """Greedy-decode ``steps`` tokens a slot through speculation rounds.
        ``stage_arrival(emitted)`` is consulted between rounds (True: the
        next stage landed, upgrade in place); ``on_round`` sees each
        round's accept record.

        One-shot per :meth:`start`: slots finish ragged and fast slots'
        surplus tokens are dropped, so no coherent state remains to resume
        from."""
        if getattr(self, "_decoded", True):
            raise RuntimeError(
                "speculative decode is one-shot per start(): surplus tokens of fast "
                "slots are discarded at the end of a run, so continuing would skip "
                "them — call start() again to begin a new generation")
        # validated before the one-shot is consumed: a refused call leaves
        # the started generation decodable
        need = int(self._pos_np.max()) + steps + self.spec.k_max - 1
        if need > self.max_len:
            raise ValueError(
                f"decoding {steps} steps needs max_len >= prompt + steps + k_max - 1 = "
                f"{need}, got {self.max_len} (the final rounds' verify blocks would "
                f"clamp at the cache end)")
        self._decoded = True
        B = int(self._first_tok.shape[0])
        emitted: list[list[int]] = [[] for _ in range(B)]
        stage_log: list[list[int]] = [[] for _ in range(B)]
        upgrades: list[tuple[int, int]] = []
        t_start = time.perf_counter()
        first = self._first_tok[:, 0].cpu().numpy()   # the prefill's argmax
        ttft = time.perf_counter() - t_start
        for b in range(B):
            emitted[b].append(int(first[b]))
            stage_log[b].append(self.stage)
        last_tok = self._first_tok
        rounds = drafted = accepted_total = 0
        n_rounds_guard = steps * (B + 1) + 8
        while min(len(e) for e in emitted) < steps:
            if rounds > n_rounds_guard:
                raise AssertionError("speculative decode did not converge")
            done = min(len(e) for e in emitted)
            if stage_arrival and self.stage < self.prog.n_stages and stage_arrival(done):
                self.receive_stage()
                upgrades.append((done, self.stage))
            self._sync_draft_view()
            active = np.array([len(e) < steps for e in emitted])
            pos_masked = np.where(active, self._pos_np, -1).astype(np.int32)
            # the headroom was validated: every active slot takes a full
            # k_max block, so k never shrinks near the end
            k_eff = self.choose_k()
            g, acc, last_tok, self.caches = self._run_round(
                self.caches, last_tok, to_device(pos_masked, self.device), k_eff)
            got = torch.cat([acc[:, None], g], dim=1).cpu().numpy()   # once a round
            acc_np, g_np = got[:, 0], got[:, 1:]
            for b in range(B):
                if not active[b]:
                    continue
                take = int(acc_np[b]) + 1
                emitted[b].extend(int(t) for t in g_np[b, :take])
                stage_log[b].extend([self.stage] * take)
                self._pos_np[b] += take
            n_active = int(active.sum())
            drafted += k_eff * n_active
            accepted_total += int(acc_np[active].sum())
            self.controller.update(int(acc_np[active].sum()), k_eff * n_active)
            rec = {"round": rounds, "k": k_eff, "accepted": [int(a) for a in acc_np[active]],
                   "rate": self.controller.rate, "stage": self.stage,
                   "emitted": [len(e) for e in emitted]}
            self.accept_log.append(rec)
            if on_round is not None:
                on_round(rec)
            rounds += 1
        wall = time.perf_counter() - t_start
        self.last_logits = None   # the plain path's handle is stale now
        return SpeculativeResult(
            tokens=torch.tensor(np.array([e[:steps] for e in emitted], np.int64)),
            stage_log=[s[:steps] for s in stage_log], upgrades=upgrades,
            accept_rounds=list(self.accept_log[-rounds:] if rounds else []),
            rounds=rounds, drafted=drafted, accepted=accepted_total, wall_s=wall,
            ttft_s=ttft)


class SpeculativeSlotPool(_SpeculativeMixin, SlotPoolEngine):
    """Continuous-batching speculation: one draft chain and one verify
    pass serve every decoding slot a round, ragged positions and all.
    Admission follows the base pool. Chunked (the default): a slot joins
    the rounds once its last chunk lands, and its first greedy token,
    captured on the device, is emitted at the next flush. Batch-1
    (``chunked_prefill=False``): the prefill's argmax is the request's
    first token, emitted at admission (one host read of that token, as
    the reference does). Budget and eos eviction happen at flush, where
    the rounds' acceptance counts become host-visible."""

    def __init__(self, model, prog, *, n_slots: int, max_len: int, receiver=None,
                 spec: SpecConfig | None = None, dispatch_window: int = 4,
                 eos_id: int | None = None, chunked_prefill: bool | None = None,
                 prefill_chunk: int = 8, prefill_buckets: bool = True,
                 double_buffer: bool = True, mesh=None, device="cuda"):
        spec = spec or SpecConfig()
        super().__init__(model, prog, n_slots=n_slots, max_len=max_len, receiver=receiver,
                         resident="quantized", dispatch_window=dispatch_window,
                         eos_id=eos_id, ring_margin=spec.k_max + 1,
                         chunked_prefill=chunked_prefill,
                         prefill_chunk=prefill_chunk, prefill_buckets=prefill_buckets,
                         double_buffer=double_buffer, mesh=mesh, device=device)
        self._init_spec(spec)
        # per-slot position ceiling (prompt + budget - 1): a slot whose
        # budget is met rides rounds until flush evicts it, but its
        # position freezes here, inside the headroom submit() validated
        self._pos_bound = torch.full((n_slots,), max_len, dtype=torch.int32,
                                     device=self.device)
        # chunk-admitted slots whose first token awaits the next flush:
        # (slot, rid, stage at prefill completion)
        self._deferred_first: list[tuple[int, int, int]] = []

    # -- admission ----------------------------------------------------------
    def _validate_request(self, req) -> None:
        super()._validate_request(req)
        prompt_len = np.asarray(req.prompt).shape[0]
        if prompt_len + req.max_new_tokens + self.spec.k_max > self.max_len:
            # the last round at pos = prompt + budget - 1 writes k_max more rows
            raise ValueError(
                f"request needs {prompt_len} prompt + {req.max_new_tokens} new tokens + "
                f"{self.spec.k_max} verify headroom > max_len {self.max_len}")

    def _post_admit(self, slot: int, req, prompt_len: int) -> None:
        self._pos_bound[slot:slot + 1].fill_(prompt_len + req.max_new_tokens - 1)

    def _post_admit_batch1(self, slot: int, req, last_logits, prompt_len: int) -> None:
        first = torch.argmax(last_logits, dim=-1).to(torch.int32)      # (1,)
        self._last_tok[slot:slot + 1].copy_(first[:, None])
        # the prefill's argmax is the request's first greedy token, emitted
        # at admission (the plain pool emits the same token on the
        # request's first step)
        self._note_first_token(req.rid)
        self.outputs[req.rid].append(int(first[0]))
        self.stage_log[req.rid].append(self.stage)
        self.slots[slot].dispatched = 1
        if req.max_new_tokens == 1:
            self._evict(slot)

    def _on_prefill_complete(self, slot: int) -> None:
        # the chunk step captured the first greedy token in _first_cap on
        # the device; it is emitted at the next flush, before any round
        # that includes this slot
        self._deferred_first.append((slot, self.slots[slot].rid, self.stage))

    # -- one round for the whole pool ---------------------------------------
    def step(self) -> dict[int, int]:
        """One scheduling tick: advance chunked prefills by one block, then
        one batched speculation round (k draft decode_steps and one verify
        pass) over every decoding slot; free and mid-prefill slots ride
        along masked (``pos = -1``). Nothing here reads the device."""
        if self.params is None:
            raise RuntimeError("no planes received yet — call receive_stage()")
        if self._win_t0 is None:
            self._win_t0 = time.perf_counter()
        self._prefill_tick()
        snapshot = self.active_rids()
        if not snapshot:
            return snapshot
        self._sync_draft_view()
        # submit() validated prompt + budget + k_max <= max_len, so a full
        # k-draft block always fits
        k_eff = self.choose_k()
        g, acc, nxt, self.caches = self._run_round(self.caches, self._last_tok, self.pos,
                                                   k_eff)
        # the decoding slots (the snapshot) are exactly those with pos >= 0
        act = self.pos >= 0
        self.pos = torch.where(act, torch.minimum(self.pos + acc + 1, self._pos_bound),
                               self.pos)
        self._last_tok = torch.where(act[:, None], nxt, self._last_tok)
        self._pending.append((g, acc, snapshot, self.stage, k_eff))
        self._step_count += 1
        return snapshot

    def _flush_deferred_first(self, first_np: np.ndarray) -> int:
        """Emit the captured first token of every chunk-admitted request
        whose prefill completed since the last flush; it precedes every
        round that included the slot."""
        emitted = 0
        for slot, rid, stage in self._deferred_first:
            s = self.slots[slot]
            if s.free or s.rid != rid:
                continue
            tok = int(first_np[slot])
            self._note_first_token(rid)
            self.outputs[rid].append(tok)
            self.stage_log[rid].append(stage)
            s.dispatched += 1
            emitted += 1
            if s.dispatched >= s.budget or (self.eos_id is not None and tok == self.eos_id):
                self._evict(slot)
        self._deferred_first.clear()
        return emitted

    def flush(self) -> PoolStepStats | None:
        """Read the window's first tokens, rounds' tokens and acceptance
        counts in one host read, hand them out, and do the budget and eos
        bookkeeping that the plain pool does at dispatch time."""
        if not self._deferred_first and not self._pending:
            # budget-1 admissions can retire a request without a round
            self.completed |= self._retired
            self._retired.clear()
            return None
        n = self.n_slots
        parts = [self._first_cap] if self._deferred_first else []
        for g, acc, *_ in self._pending:
            parts += [acc, g.reshape(-1)]
        flat = torch.cat(parts).cpu().numpy()   # the window's one host sync
        off = 0
        emitted = 0
        if self._deferred_first:
            emitted = self._flush_deferred_first(flat[:n])
            off = n
        if not self._pending:
            self.completed |= self._retired
            self._retired.clear()
            return None
        wall = time.perf_counter() - (self._win_t0 or time.perf_counter())
        for g, _, snapshot, stage, k_eff in self._pending:
            T = g.shape[1]
            acc_np = flat[off:off + n]
            g_np = flat[off + n:off + n + n * T].reshape(n, T)
            off += n + n * T
            self.accept_log.append({"k": k_eff,
                                    "accepted": [int(acc_np[s]) for s in snapshot],
                                    "rate": self.controller.rate, "stage": stage})
            self.controller.update(int(sum(acc_np[s] for s in snapshot)),
                                   k_eff * len(snapshot))
            for slot, rid in snapshot.items():
                if rid in self.completed or rid in self._retired:
                    continue   # evicted while this round was in flight
                s = self.slots[slot]
                take = min(int(acc_np[slot]) + 1, max(s.budget - s.dispatched, 0))
                s.dispatched += take
                for tok in g_np[slot, :take]:
                    self.outputs[rid].append(int(tok))
                    self.stage_log[rid].append(stage)
                    emitted += 1
                    if self.eos_id is not None and int(tok) == self.eos_id:
                        self._evict(slot)
                        break
                if not s.free and s.rid == rid and s.dispatched >= s.budget:
                    self._evict(slot)
        self.completed |= self._retired
        self._retired.clear()
        stats = PoolStepStats(steps=len(self._pending), wall_s=wall, tokens_emitted=emitted,
                              upgrades=self._win_upgrades,
                              upgrade_enqueue_s=self._win_upgrade_enqueue_s,
                              prefill_ticks=self._win_prefill_ticks)
        return self._record_window(stats)
