#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA H100 and hold every
CUDA kernel of those paths against its plain PyTorch version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero); each path runs
with the launch counts set to 0 just before it and read just after:

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` per source, all at once;
2. ``[divide]``: split full-width olmo-1b into eight 2-bit planes on the
   card (``plane_extract``, 8 launches a tensor); the in-memory receiver
   after all 8 stages holds ``quantize(leaf).q`` of every tensor, bit for
   bit; every plane of the largest tensor equals the plain version;
3. serve full-width olmo-1b from its plane accumulators:
   ``ProgressiveServer(resident="quantized")``, one stage, a (4, 64)
   prompt, 48 decode steps with the other 7 stages landing mid-decode;
   then the slot pool on the same planes: ``SlotPoolEngine`` with 8
   slots, 12 requests of ragged prompts admitted by chunked prefill while
   the other slots decode, an upgrade every window from stage 1 to 8;
   then self-speculation on the same planes. ``[spec]``:
   ``SpeculativeEngine`` (draft 4 bits), (a) at each of the 8 stages
   from a fresh start at batch 4, 24 tokens, k = 4 and adaptive, each
   ``torch.equal`` to ``ProgressiveServer`` at that stage, (b) at batch
   1, 48 tokens with stages 2-8 landing between rounds, ``torch.equal``
   to a batch-1 server replayed at the run's per-token stage log (the
   plain server's runs come before the counts); every B2 launch but the
   prefills' layer weights on the GEMV route's one-pass kernels, verify
   passes included; the draft view shares every q of the target view
   (zero extra bytes). ``[spec pool]``:
   ``SpeculativeSlotPool`` (k = 3) on the pool's 12 requests at stage 8,
   each request's tokens ``torch.equal`` to a plain ``SlotPoolEngine``'s.
   ``[reject]``: both engines again, on the same seed-0 weights with the
   decoder's scaled by 2, where the 4-bit draft is rejected in part,
   tokens ``torch.equal`` to the plain engines' (stages 4-8; the pool);
4. ``[wire]``: the same model from wire bytes: ``wire.encode`` (v3),
   ``ProgressiveClient.feed`` in seeded ragged chunks of 1 B to 64 MB,
   one stage at each arrival of phase 3's schedule, and
   ``ProgressiveServer(receiver=WireStoreReceiver(...))``: the store's
   fingerprint equals the in-memory receiver's after every stage and the
   tokens equal phase 3's; a unit of stage 3 damaged on a second feed is
   quarantined and repaired to the clean fingerprint; raw v1 streams the
   2-layer full-width model the same way;
   ``[session]``: the byte-clock ``Session`` over ``pod-coldstart``
   (200 MB/s, 1 MB chunks) at full width: ``run_timeline`` within 1e-9 s
   of ``progressive_timeline``; ``run_serving`` quantized, ``torch.equal``
   to a ``ProgressiveServer(receiver=)`` replay at its per-step stages,
   and in float residency, its logits within ``FP_LOGIT_RTOL`` of the
   quantized run's and its tokens equal wherever the margin clears it;
   both decode rates at stage 8 and the float upgrade against its bytes
   bound; a faulted run (the CLI's default profile) whose store equals
   the clean one and whose final tokens equal a clean run's;
   ``run_serving_pool``; then the small-chunk scenarios on the 2-layer
   full-width model (the lossy ones end in ``TransportError`` there) and
   the lossy ones on reduced olmo-1b, recovered. ``[cli]``: ``python -m
   repro_torch.launch.serve --arch olmo-1b --scenario pod-coldstart`` at
   full width, as a process of its own;
5. ``[upgrade per tensor]``: stage 8 as one ``plane_or`` a tensor on the
   live stage-7 accumulator views, byte-equal to the batched
   ``plane_or_segments`` upgrade, both timed;
6. hold each kernel against its plain version on the paths' operands
   (``dequant_matmul`` on both routes, GEMV and tensor-core, at M = 4, 8,
   64 and 256, with activations of zero and of large positive mean; every
   row of a GEMV launch at M = 4 and 8 ``torch.equal`` to that row
   launched alone; the plane mask ``keep`` = 0, 2, 4, 8, 16 on both
   routes and on the forced GEMV route (``rows="decode"``) at the verify
   shapes M = 5, 20, 32, 72, a full-width keep bit-equal to none, and
   every forced-GEMV row at those M equal to the row alone), every
   ``flash_verify`` row against a ``flash_decode`` launch (T = 8 and the
   verify shapes T = 2, 5, 9), and a verify step's logits and the K/V it
   writes ``torch.equal`` to sequential decode steps after reject-all,
   alternate and accept-all rounds;
7. run the same 2-layer full-width model on the card (kernels) and on
   the CPU (plain versions) and compare teacher-forced decode, prefill
   chunk and verify logits;
8. time each kernel at the paths' shapes beside its bound, its plain
   version and one PyTorch call (or chain of calls) that computes the
   same function: ``dequant_matmul`` over a decode step's (M = 4), the
   pool's decode step's (M = 8), a chunk tick's and the prefill's
   operands, and both of its routes at M = 1 to 256; both attention
   kernels at the paths' shapes and on one synthetic layer at S = 1024
   and 4096 keys; one chunk tick of the pool and the single stream's
   prefill; the plane mask's cost over a decode step's launches; one
   verify step at M = 20 and 32 on either route and a speculation
   round.

``dequant_matmul``'s launches are also counted by route on every path:
the prefill and the chunk ticks run the tensor-core kernel, decode and
verify the GEMV route, every launch of it on its one-pass kernels
(checked on each path).

The second-to-last line is a JSON object with one entry per kernel, the
last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # float32 outside the tensor cores
BF16_FLOPS = 989e12         # bf16 on the tensor cores (dequant_matmul's mma route)

DEVICE = "cuda"
BATCH, PROMPT, STEPS = 4, 64, 48
ARRIVALS = (6, 12, 18, 24, 30, 36, 42)
# the slot pool: 8 slots, 8-token prefill chunks, 8-step windows, 12
# requests (prompts 16-96 tokens, budgets 24-40, numpy seed 3)
POOL_SLOTS, POOL_CHUNK, POOL_WINDOW, POOL_MAX_LEN = 8, 8, 8, 160
POOL_REQUESTS = 12
# dequant_matmul's rows: checked at the paths' M (decode, the pool's
# decode, a chunk tick, the prefill), both routes timed at each of these
DQMM_CHECK_M = (4, 8, 64, 256)
# self-speculation: verify's rows (batch 1 at k = 4, batch 4 at k = 4,
# the pool's 8 slots at k = 3, 8 slots at k = 8), the masks checked, the
# verify blocks' T, and the single stream's tokens a start
VERIFY_M = (5, 20, 32, 72)
KEEP_CHECK = (0, 2, 4, 8, 16)
VERIFY_T = (2, 5, 9)
SPEC_TOKENS = 24
# the speculative paths are also run on phase 2's weights with the
# decoder's scaled by this, where the 4-bit draft is rejected in part
DECODER_SCALE = 2.0
DQMM_TIME_M = (1, 2, 4, 8, 12, 16, 32, 64, 256)
# the attention kernels are also checked and timed on one synthetic layer
# at these cache lengths (keys), beyond what the body's ring holds at once
ATTN_LONG_S = (1024, 4096)
# wire chunks: log-uniform from 1 byte to 64 MB (numpy seed 5)
CHUNK_MAX = 64 << 20

# Stated tolerances, each with its reason.
# dequant_matmul: on both routes q is centred (so the two epilogue terms
# do not cancel), the products are exact (bfloat16 x) or rounded once
# (float32 x on the GEMV route) and only the float32 sums over K (<= 8192
# terms) round, where the plain version rounds each weight and sums in
# another order: error far below 1e-4 of the output's largest magnitude.
DQMM_RTOL = 1e-4
# decode_attention and flash_verify: the kernels write bfloat16, the
# plain versions float32; one bfloat16 rounding is 2**-9 relative, allow
# 2**-7 of the largest output magnitude.
ATTN_RTOL = 2.0 ** -7
# whole path: bfloat16 activations rounded at other places by the two
# sums orders compound over 2 layers; allow 3% of the largest logit.
PATH_RTOL = 3e-2
# float residency against quantized on the same byte clock: the float
# path rounds every weight to bfloat16 (2**-9 relative) before a cuBLAS
# product, B2 multiplies the exact dequantised weight; over 16 layers
# allow 5% of the largest logit, and hold the greedy tokens equal only
# where the top two logits are further apart than twice that.
FP_LOGIT_RTOL = 5e-2

# [session]: the byte-clock Session on full-width olmo-1b over this
# scenario (200 MB/s, 1 MB chunks), SESSION_STEPS decode steps at batch
# 4; each stage's simulated processing cost (concat, dequant, inference
# seconds) in run_timeline; the pool's 12 requests SESSION_POOL_TOKENS
# tokens each; the 2-layer model over the small-chunk and lossy scenarios
SESSION_SCENARIO = "pod-coldstart"
SESSION_STEPS = 48
SESSION_STAGE_COST = (0.0, 0.0, 0.05)
SESSION_POOL_TOKENS = 32
SESSION_POOL_ROUNDS = 48
SMALL_CHUNK_SCENARIOS = ("browser-3g", "browser-lte-handoff", "edge-stall", "flash-crowd")
LOSSY_SCENARIOS = ("browser-3g-lossy", "edge-flaky")
CLI_TIMEOUT_S = 400


def check(ok: bool, what="check failed") -> None:
    """Raise unless ``ok``: every phase's checks, kept under ``python -O``."""
    if not ok:
        raise RuntimeError(str(what))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    return out.splitlines()[0]


def device_ms(fn, reps: int) -> float:
    """Device time of one ``fn()`` in ms: ``reps`` calls captured in one
    CUDA graph, replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int) -> float:
    """Host time in ms to issue one ``fn()``: no synchronisation inside."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def bound_ms(n_bytes: float, n_ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_counters() -> dict:
    """Each kernel's launch counter (its wrapper module and the counter's
    name there), by its name in the kernels line."""
    from repro_torch.kernels import bitplane, decode_attention, dequant_matmul
    from repro_torch.kernels import verify_attention

    return {"plane_or_segments": (bitplane, "launches"),
            "dequant_matmul": (dequant_matmul, "launches"),
            "decode_attention": (decode_attention, "launches"),
            "flash_verify": (verify_attention, "launches"),
            "plane_or": (bitplane, "plane_or_launches"),
            "plane_extract": (bitplane, "plane_extract_launches")}


def reset_counts(ops) -> None:
    from repro_torch.kernels import dequant_matmul

    for mod, attr in kernel_counters().values():
        setattr(mod, attr, 0)
    for by in (dequant_matmul.launches_by_route, dequant_matmul.launches_by_gemv_kernel):
        by.update(dict.fromkeys(by, 0))
    ops.reset_launch_counts()


def route_counts() -> dict:
    """``dequant_matmul``'s CUDA launches by route since the last reset."""
    from repro_torch.kernels import dequant_matmul

    return dict(dequant_matmul.launches_by_route)


def check_one_pass(routes: dict, what: str) -> dict:
    """Every GEMV-route launch since the last reset (decode's layer weights
    and, below ``MMA_MIN_M``, its unembedding) went through the one-pass
    kernels: none through the general ones. Returns the counts."""
    from repro_torch.kernels import dequant_matmul

    by = dict(dequant_matmul.launches_by_gemv_kernel)
    check(by["general"] == 0 and by["one_pass"] == routes["gemv"] > 0, (what, by, routes))
    return by


def expect_routes(calls) -> dict:
    """Launches by route for ``calls``: (launches, M) pairs, all on uint16
    accumulators."""
    from repro_torch.kernels import dequant_matmul

    want = dict.fromkeys(dequant_matmul.launches_by_route, 0)
    for n, M in calls:
        want[dequant_matmul.route(M, torch.uint16)] += n
    return want


def pass_calls(layers: int, passes: int, M: int) -> list:
    """``passes`` forward passes at M rows: 7 launches a layer on the (K, N)
    layer weights and the unembedding on the K-contiguous ``embed.T``."""
    return [(passes * layers * 7, M), (passes, M)]


def counts(names=None) -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in kernel_counters().items()
            if names is None or name in names}


class FiniteLogits:
    """Wraps a Model: records, without a host sync, whether the logits of
    every decode step and prefill chunk were finite."""

    def __init__(self, model):
        self.model = model
        self.flags: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, caches, tokens, pos):
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.flags.append(torch.isfinite(logits).all())
        return logits, caches

    def prefill_chunk(self, params, caches, tokens, tok_pos):
        logits, caches = self.model.prefill_chunk(params, caches, tokens, tok_pos)
        self.flags.append(torch.isfinite(logits).all())
        return logits, caches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import ReceiverState
    from repro_torch.kernels import bitplane, build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.kernels import verify_attention as va
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer
    from repro_torch.serving.engine import ProgressiveServer, _chunk_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_script = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    log(f"[build] {len(build.SOURCES)} kernel sources built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    print(gpu_line(), flush=True)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- 2. divide on the card -----------------------------------------------
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    prog, n_params, clean_fps, divide_counts = _divide_phase(model, dev, ops)

    # -- 3. full-width serve -------------------------------------------------
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    checked = FiniteLogits(model)
    srv = ProgressiveServer(checked, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev)
    torch.cuda.synchronize()
    serve_kernels = ("plane_or_segments", "dequant_matmul", "decode_attention")
    reset_counts(ops)
    t0 = time.perf_counter()
    srv.receive_stage()
    srv.start({"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill, prefill_routes = counts(serve_kernels), route_counts()
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    torch.cuda.synchronize()
    path_counts, serve_routes = counts(serve_kernels), route_counts()
    serve_gemv = check_one_pass(serve_routes, "serve")
    op_counts = dict(ops.LAUNCH_COUNTS)
    decode_s = sum(s for _, s in res.window_s)

    layers = cfg.n_layers
    per_step = {k: (path_counts[k] - after_prefill[k]) / STEPS for k in path_counts}
    report = srv.resident_report()
    check(srv.stage == prog.n_stages == 8, f"ended at stage {srv.stage}")
    check([s for _, s in res.upgrades] == list(range(2, 9)), res.upgrades)
    check(bool(torch.stack(checked.flags).all()), "non-finite decode logits")
    check(bool(torch.isfinite(srv.last_logits).all()))
    check(res.tokens.shape == (BATCH, STEPS))
    check(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab)
    check(report["fp_bytes"] == 0, report["fp_bytes"])
    check(report["quantized_bytes"] == 2 * n_params, (report["quantized_bytes"], n_params))
    check(per_step["dequant_matmul"] == layers * 7 + 1, per_step)
    check(per_step["decode_attention"] == layers, per_step)
    check(path_counts["plane_or_segments"] == 8, path_counts)
    check(all(path_counts[k] > 0 for k in path_counts))
    check(op_counts == path_counts, (op_counts, path_counts))
    # the prefill's layer weights at M = BATCH * PROMPT and its unembedding
    # of the last position at M = BATCH; decode at M = BATCH
    prefill_calls = [(layers * 7, BATCH * PROMPT), (1, BATCH)]
    check(prefill_routes == expect_routes(prefill_calls), prefill_routes)
    check(serve_routes == expect_routes(prefill_calls + pass_calls(layers, STEPS, BATCH)),
          serve_routes)
    tok_s = BATCH * STEPS / decode_s
    log(f"[serve] stages {res.stage_at_step[0]}->{res.stage_at_step[-1]}, upgrades "
        f"{res.upgrades}; logits finite; resident {report['quantized_bytes']} B "
        f"quantized, {report['fp_bytes']} B fp")
    log(f"[serve] launches in the run {path_counts}; per decode step "
        f"dequant_matmul {per_step['dequant_matmul']:.0f}, decode_attention "
        f"{per_step['decode_attention']:.0f}; dequant_matmul by route: prefill "
        f"{prefill_routes}, whole run {serve_routes}; GEMV route by kernel {serve_gemv}")
    log(f"[serve] receive_stage + prefill {t_prefill * 1e3:.1f} ms; decode "
        f"{STEPS} steps x {BATCH} slots with 7 upgrades: {decode_s:.3f} s, "
        f"{tok_s:.1f} tokens/s, {decode_s / STEPS * 1e3:.2f} ms/step")

    # upgrade latency on a fresh store: host clock around one
    # receive(), synchronised before and after
    state = ReceiverState.init(prog, device=dev)
    upgrade_ms = []
    for s in range(1, prog.n_stages + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = state.receive(prog.stage(s))
        state.materialize_resident()
        torch.cuda.synchronize()
        upgrade_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[serve] upgrade (ingest + view refresh, synchronised) ms per stage: "
        f"{[round(u, 2) for u in upgrade_ms]}")
    del state

    # the slot pool on the same planes
    pool, pool_counts, pool_routes = _pool_phase(model, prog, dev, ops)

    # self-speculation on the same planes: the single stream and the pool
    spec = _spec_phase(model, prog, dev, ops, prompt, report["quantized_bytes"])
    spec_pool = _spec_pool_phase(model, prog, dev, ops)
    # both speculative engines on a model whose draft the target rejects
    prog_scaled = _scaled_model(model, dev)
    _spec_rejections(model, prog_scaled, prompt, dev)
    _spec_pool_rejections(model, prog_scaled, dev)
    del prog_scaled

    # -- 4. the same model from wire bytes -----------------------------------
    wire_counts, wire_routes = _wire_phase(model, prog, dev, ops, prompt, res, clean_fps,
                                           serve_routes)
    _wire_v1_check(cfg, dev)

    # -- 4b. the byte-clock Session and the CLI ------------------------------
    t0 = time.perf_counter()
    session = _session_phase(model, prog, dev, ops, prompt, clean_fps)
    _session_small(cfg, dev, ops, session["counts"], session["routes"])
    log(f"[session] launches on the path {session['counts']}, dequant_matmul by route "
        f"{session['routes']}; {time.perf_counter() - t0:.1f} s")
    _cli_phase()

    # -- 5. stage 8 one tensor at a time -------------------------------------
    # the accumulators after stage 7, stage 8's operands, and the batched
    # upgrade's result (the stage-8 accumulators: q of every tensor)
    upgrade_counts, acc, plane, shifts, out, per_tensor, slots = _upgrade_phase(prog, dev,
                                                                                ops)

    # -- 6. each kernel against its plain version on the path's operands ----
    kern: dict[str, dict] = {"plane_or": {"max_abs_err": 0},
                             "plane_extract": {"max_abs_err": 0}}
    # plane_or_segments: the accumulators after stage 7 and stage 8's plane
    exact = True
    chunk = 1 << 26
    for c0 in range(0, acc.numel(), chunk):
        sl = slice(c0, c0 + chunk)
        want = ref.plane_or_segments_ref(acc[sl], plane[sl], shifts[c0 // 1024:
                                         (c0 + chunk) // 1024], 1024)
        exact &= bool(torch.equal(out[sl], want))
    check(exact, "plane_or_segments differs from its plain version")
    kern["plane_or_segments"] = {"max_abs_err": 0}
    log(f"[check] plane_or_segments on the {acc.numel()}-element uint16 buffer: exact")

    # dequant_matmul: both routes at the paths' M (decode 4, the pool's
    # decode 8, a chunk tick 64, the prefill 256) on the live stage-8
    # accumulators of layer 0 and on embed.T, float32 and bfloat16 x, of
    # zero mean and of large positive mean
    P = srv.params
    l0 = layer(P["decoder"]["cycles"]["0_attn"], 0)
    weights = {"attn.wq": l0["attn"]["wq"], "mlp.wi_gate": l0["mlp"]["wi_gate"],
               "mlp.wo": l0["mlp"]["wo"], "embed.T": P["embed"].T}
    xg = torch.Generator(device=dev).manual_seed(2)
    routes = {"gemv": dqm._launch_gemv, "mma": dqm._launch_mma}
    route_err, worst = dict.fromkeys(routes, 0.0), {}
    for name, w in weights.items():
        K = w.q.shape[0]
        for M in DQMM_CHECK_M:
            for xkind in ("randn", "silu", "relu3"):
                x = torch.randn((M, K), generator=xg, device=dev)
                x = {"randn": x, "silu": torch.nn.functional.silu(2 * x),
                     "relu3": torch.relu(x) + 3}[xkind]
                for xd in (torch.float32, torch.bfloat16):
                    xt = x.to(xd)
                    yr = ref.dequant_matmul_ref(xt, w.q, w.scale, w.offset)
                    mag = float(yr.abs().max())
                    for kernel, launch in routes.items():
                        y = launch(xt, w.q, w.scale, w.offset)
                        err = float((y - yr).abs().max())
                        check(err <= DQMM_RTOL * mag, (name, M, xkind, xd, kernel, err, mag))
                        route_err[kernel] = max(route_err[kernel], err)
                        key = (name, M)
                        worst[key] = max(worst.get(key, 0.0), err / mag)
        log(f"[check] dequant_matmul {name} K={K} N={w.q.shape[1]} q strides "
            f"{tuple(w.q.stride())}, routes {list(routes)}, x randn / silu / "
            f"relu+3 in float32 and bfloat16: max |err| / max |y| by M "
            + ", ".join(f"{M}: {worst[(name, M)]:.2e}" for M in DQMM_CHECK_M)
            + f" (tolerance {DQMM_RTOL})")
    log(f"[check] dequant_matmul largest |err| by route: {route_err}")
    # below MMA_MIN_M a GEMV row does not depend on M: at the decode paths'
    # M every row of a launch equals (torch.equal) that row launched alone,
    # and a second launch repeats the first, in the dtypes the model passes
    for name, w in weights.items():
        xd = torch.float32 if name == "embed.T" else cfg.dtype
        for M in (BATCH, POOL_SLOTS):
            check(dqm.route(M, w.q.dtype) == "gemv", (name, M))
            x = torch.randn((M, w.q.shape[0]), generator=xg, device=dev).to(xd)
            y = dqm.dequant_matmul(x, w.q, w.scale, w.offset)
            check(torch.equal(dqm.dequant_matmul(x, w.q, w.scale, w.offset), y),
                  f"dequant_matmul {name} M={M}: two launches differ")
            for i in range(M):
                check(torch.equal(dqm.dequant_matmul(x[i:i + 1], w.q, w.scale, w.offset),
                                  y[i:i + 1]),
                      f"dequant_matmul {name}: row {i} of an M={M} launch differs alone")
    log(f"[check] dequant_matmul GEMV route on {list(weights)}: every row of an M = "
        f"{BATCH} and an M = {POOL_SLOTS} launch equal (torch.equal) to a 1-row launch, "
        f"and launches repeat bit for bit")
    # the plane mask as an operand: keep = 0, 2, 4, 8, 16 on both routes at
    # the paths' M, and on the forced GEMV route (rows="decode") at the
    # verify shapes, against the plain version on the masked q; a
    # full-width keep is bit-equal to the unmasked launch
    keep_err, keep_abs = dict.fromkeys(routes, 0.0), dict.fromkeys(routes, 0.0)
    keep_mag = 0.0
    for name, w in weights.items():
        K = w.q.shape[0]
        xd = torch.float32 if name == "embed.T" else cfg.dtype
        full = torch.full((1, 1), 16, dtype=torch.int32, device=dev)
        for M in DQMM_CHECK_M + VERIFY_M:
            x = (torch.relu(torch.randn((M, K), generator=xg, device=dev)) + 3).to(xd)
            kinds = routes if M in DQMM_CHECK_M else {"gemv": routes["gemv"]}
            for keep in KEEP_CHECK:
                kt = torch.full((1, 1), keep, dtype=torch.int32, device=dev)
                yr = ref.dequant_matmul_ref(x, w.q, w.scale, w.offset, kt)
                mag = float(yr.abs().max())
                keep_mag = max(keep_mag, mag)
                for kernel, launch in kinds.items():
                    err = float((launch(x, w.q, w.scale, w.offset, kt) - yr).abs().max())
                    check(err <= DQMM_RTOL * mag, (name, M, keep, kernel, err, mag))
                    keep_err[kernel] = max(keep_err[kernel], err / mag)
                    keep_abs[kernel] = max(keep_abs[kernel], err)
            for kernel, launch in kinds.items():
                check(torch.equal(launch(x, w.q, w.scale, w.offset, full),
                                  launch(x, w.q, w.scale, w.offset)),
                      f"{name} M={M} {kernel}: a full-width keep changes bits")
    log(f"[check] dequant_matmul with the plane mask keep = {list(KEEP_CHECK)} on "
        f"{list(weights)}, relu+3 x in the model's dtypes: both routes at M = "
        f"{list(DQMM_CHECK_M)}, the forced GEMV route at M = {list(VERIFY_M)}; max |err| / "
        f"max |y| by route {', '.join(f'{k} {v:.2e}' for k, v in keep_err.items())} "
        f"(tolerance {DQMM_RTOL}; max |err| {keep_abs}, largest max |y| {keep_mag:.1f}); a "
        f"full-width keep bit-equal to no keep")
    # the forced GEMV route (verify's rows="decode") at the verify shapes:
    # every row equal to that row launched alone, masked or not
    four = torch.full((1, 1), 4, dtype=torch.int32, device=dev)
    for name, w in weights.items():
        xd = torch.float32 if name == "embed.T" else cfg.dtype
        x = torch.randn((max(VERIFY_M), w.q.shape[0]), generator=xg, device=dev).to(xd)
        for kt in (None, four):
            alone = torch.cat([dqm.dequant_matmul(x[i:i + 1], w.q, w.scale, w.offset, kt,
                                                  rows="decode") for i in range(x.shape[0])])
            for M in VERIFY_M:
                y = dqm.dequant_matmul(x[:M], w.q, w.scale, w.offset, kt, rows="decode")
                check(torch.equal(y, alone[:M]), f"dequant_matmul {name} rows='decode' "
                      f"M={M} keep={kt is not None}: a row differs alone")
    log(f"[check] dequant_matmul rows='decode' on {list(weights)}: every row of an M = "
        f"{list(VERIFY_M)} launch equal (torch.equal) to that row launched alone, without "
        f"a mask and with keep = 4")
    # each route's entry in the kernels line carries its own largest error
    # unmasked; the masked checks' errors ride beside it
    kern["dequant_matmul"] = {"max_abs_err": route_err["gemv"], "keep_checked": KEEP_CHECK,
                              "keep_max_rel_err": keep_err, "keep_max_abs_err": keep_abs}

    # decode_attention: layer 0's live cache, slot 1 ragged (its keys past
    # position 40 empty), slot 3 free
    cache = layer(srv.caches["cycles"]["0_attn"], 0)
    S = cache["k"].shape[2]
    k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(BATCH, 1)
    k_pos[1, 41:] = -1
    q_pos = torch.tensor([S - 1, S - 1, 70, -1], dtype=torch.int32, device=dev)
    q = torch.randn((BATCH, cfg.n_heads, cfg.hd), generator=xg, device=dev).to(cfg.dtype)
    o = da.flash_decode(q, cache["k"], cache["v"], k_pos, q_pos)
    orf = ref.flash_decode_ref(q, cache["k"], cache["v"], k_pos, q_pos)
    check(bool(torch.isfinite(o).all()), "non-finite attention output")
    at_err = float((o.float() - orf).abs().max())
    check(at_err <= ATTN_RTOL * float(orf.abs().max()), at_err)
    kern["decode_attention"] = {"max_abs_err": at_err}
    log(f"[check] decode_attention B={BATCH} H={cfg.n_heads} S={S} hd={cfg.hd} "
        f"(ragged slot, free slot): max |err| {at_err:.3e}")

    # flash_verify: layer 0's live pooled cache, one chunk of rows per
    # slot: slot 1 ragged (keys past 45 empty) with a short final chunk,
    # slots 2 and 3 fully masked (free, and decoding), the rest live
    pcache = layer(pool.caches["cycles"]["0_attn"], 0)
    PS, T = pcache["k"].shape[2], POOL_CHUNK
    vk_pos = torch.arange(PS, dtype=torch.int32, device=dev).repeat(POOL_SLOTS, 1)
    vk_pos[1, 46:] = -1
    base = torch.tensor([PS - T, 40, -1, -1] + [16 * i for i in range(4, POOL_SLOTS)],
                        dtype=torch.int32, device=dev)
    vq_pos = torch.where(base[:, None] >= 0,
                         base[:, None] + torch.arange(T, dtype=torch.int32, device=dev), -1)
    vq_pos[1, 6:] = -1
    vq = torch.randn((POOL_SLOTS, T, cfg.n_heads, cfg.hd), generator=xg,
                     device=dev).to(cfg.dtype)
    vo = va.flash_verify(vq, pcache["k"], pcache["v"], vk_pos, vq_pos)
    vorf = ref.flash_verify_ref(vq, pcache["k"], pcache["v"], vk_pos, vq_pos)
    check(bool(torch.isfinite(vo).all()), "non-finite verify output")
    v_err = float((vo.float() - vorf).abs().max())
    check(v_err <= ATTN_RTOL * float(vorf.abs().max()), v_err)
    for t in range(T):
        row = da.flash_decode(vq[:, t].contiguous(), pcache["k"], pcache["v"], vk_pos,
                              vq_pos[:, t].contiguous())
        check(torch.equal(vo[:, t], row), f"flash_verify row {t} differs from flash_decode")
    kern["flash_verify"] = {"max_abs_err": v_err}
    # the verify shapes T = k + 1: every row equal to a flash_decode launch
    for T2 in VERIFY_T:
        qb = torch.randn((BATCH, T2, cfg.n_heads, cfg.hd), generator=xg,
                         device=dev).to(cfg.dtype)
        qp = (torch.arange(T2, dtype=torch.int32, device=dev)
              + torch.tensor([40, PS - T2, 7, 100], dtype=torch.int32, device=dev)[:, None])
        qp[2] = -1
        kp = vk_pos[:BATCH]
        out_v = va.flash_verify(qb, pcache["k"][:BATCH], pcache["v"][:BATCH], kp, qp)
        for t in range(T2):
            row = da.flash_decode(qb[:, t].contiguous(), pcache["k"][:BATCH],
                                  pcache["v"][:BATCH], kp, qp[:, t].contiguous())
            check(torch.equal(out_v[:, t], row), f"flash_verify T={T2} row {t} differs")
    log(f"[check] flash_verify at the verify shapes T = {list(VERIFY_T)} (B={BATCH}, one "
        f"slot masked): every row equal (torch.equal) to a flash_decode launch")
    # a verify step against sequential decode steps on the full-width model
    eng = spec["engine"]
    n_rounds = _verify_patterns(model, srv.params, eng.params, eng.draft_params, dev,
                                torch.Generator(device=dev).manual_seed(6))
    log(f"[check] verify_step vs sequential decode_step, {layers} layers full width, "
        f"batch {BATCH} ragged, k = 4 (draft 4 bits): after reject-all, alternate and "
        f"accept-all ({n_rounds} rounds), every verify row's logits and every cache row "
        f"equal (torch.equal)")
    log(f"[check] flash_verify B={POOL_SLOTS} T={T} H={cfg.n_heads} S={PS} hd={cfg.hd} "
        f"(ragged slot with a short chunk, free and decoding slots masked): max |err| "
        f"{v_err:.3e}; each of the {T} rows equal (torch.equal) to a flash_decode launch")

    # -- 7. whole path: 2 layers at full width, card against CPU -------------
    t0 = time.perf_counter()
    path_err, chunk_err = _whole_path(cfg, dev)
    log(f"[path] 2-layer full width, cuda kernels vs cpu plain versions, teacher-forced "
        f"logits at all 8 stages: max |err| / max |logit| = {path_err:.3e}; prefill "
        f"chunk and verify logits at stages 1 and 8: {chunk_err:.3e} (tolerance "
        f"{PATH_RTOL}); {time.perf_counter() - t0:.1f} s")

    # -- 8. timings at the path's shapes -------------------------------------
    # Device times replay CUDA graphs, so the host's launch rate does not
    # enter them; host_ms gives the host's side. Per-step operands walk
    # the 16 layers' own weights and caches, as decode does, so the 50 MB
    # L2 holds no layer's weights from the previous call.
    n = acc.numel()
    a16, p16 = acc.view(torch.int16), plane.view(torch.int16)
    sh = int(shifts[0])
    # a uniform schedule: one shift for the whole round
    check(bool((shifts == sh).all()), "shifts differ within the round")
    b, by = bound_ms(3 * 2 * n + 4 * (n // 1024), n * 2, FP32_FLOPS)
    kern["plane_or_segments"].update(
        ms=device_ms(lambda: bitplane.plane_or_segments(acc, plane, shifts), 5),
        plain_ms=device_ms(lambda: ref.plane_or_segments_ref(acc, plane, shifts, 1024), 2),
        library_ms=device_ms(lambda: torch.bitwise_or(a16, torch.bitwise_left_shift(p16, sh)),
                             5),
        host_ms=host_ms(lambda: bitplane.plane_or_segments(acc, plane, shifts), 5),
        bound_ms=b, bound_by=by, per="one upgrade launch")
    del a16, p16

    # plane_or: stage 8 one launch a tensor on the live stage-7 views
    def upgrade_each(fn):
        for a, p, s in per_tensor:
            fn(a, p, s)

    n_el = sum(a.numel() for a, _, _ in per_tensor)
    b, by = bound_ms(sum(2 * a.numel() * a.element_size() + p.numel() * p.element_size()
                         for a, p, _ in per_tensor), 2 * n_el, FP32_FLOPS)
    kern["plane_or"].update(
        ms=device_ms(lambda: upgrade_each(lambda a, p, s: bitplane.plane_or(a, p, shift=s)),
                     3),
        plain_ms=device_ms(lambda: upgrade_each(lambda a, p, s: ref.plane_or_ref(a, p, s)),
                           2),
        library_ms=device_ms(lambda: upgrade_each(lambda a, p, s: torch.bitwise_or(
            a.view(torch.int16), torch.bitwise_left_shift(p.to(torch.int16), s))), 3),
        host_ms=host_ms(lambda: upgrade_each(lambda a, p, s: bitplane.plane_or(a, p,
                                                                               shift=s)), 3),
        bound_ms=b, bound_by=by,
        per=f"one stage-8 upgrade, a launch a tensor ({len(per_tensor)} launches)")

    # plane_extract: one 2-bit plane of every tensor from its uint16 q (the
    # stage-8 accumulators are q, bit for bit), written as uint8
    qs = [out[t.offset:t.offset + t.size].reshape(t.shape) for t in slots]

    def extract_each(fn):
        for q in qs:
            fn(q)

    b, by = bound_ms(3 * n_el, 3 * n_el, FP32_FLOPS)
    kern["plane_extract"].update(
        ms=device_ms(lambda: extract_each(lambda q: bitplane.plane_extract(
            q, bits=16, before=6, width=2, out_dtype=torch.uint8)), 3),
        plain_ms=device_ms(lambda: extract_each(lambda q: ref.plane_extract_ref(
            q, 16, 6, 2, torch.uint8)), 2),
        library_ms=device_ms(lambda: extract_each(lambda q: torch.bitwise_right_shift(
            torch.bitwise_and(torch.bitwise_left_shift(q.to(torch.int32), 6), 0xFFFF),
            14).to(torch.uint8)), 2),
        host_ms=host_ms(lambda: extract_each(lambda q: bitplane.plane_extract(
            q, bits=16, before=6, width=2, out_dtype=torch.uint8)), 3),
        bound_ms=b, bound_by=by,
        per=f"one plane of the model, a launch a tensor ({len(qs)} launches)")
    del qs, out

    # dequant_matmul: the decode step's 113 launches (M = BATCH), a chunk
    # tick's 113 (M = slots x chunk) and the prefill's 112 layer launches
    # (M = BATCH x PROMPT), each in its path's order over the 16 layers'
    # own weights; bfloat16 x for the layers, float32 for the unembedding,
    # as the model passes them
    stack = P["decoder"]["cycles"]["0_attn"]
    layer_ws = [w for r in range(layers) for w in _layer_weights(layer(stack, r))]
    emb_w = P["embed"].T
    dense = {id(w): w.q.to(torch.float32) * w.scale.reshape(()) + w.offset.reshape(())
             for w in layer_ws + [emb_w]}

    def path_calls(M, unembed=True):
        xs = {k: torch.randn((M, k), generator=xg, device=dev).to(cfg.dtype)
              for k in (cfg.d_model, cfg.d_ff)}
        calls = [(xs[w.q.shape[0]], w) for w in layer_ws]
        if unembed:
            calls.append((torch.randn((M, cfg.d_model), generator=xg, device=dev), emb_w))
        return calls

    def run(calls, fn=dqm.dequant_matmul):
        for x, w in calls:
            fn(x, w.q, w.scale, w.offset)

    calls = path_calls(BATCH)
    check(len(calls) == per_step["dequant_matmul"], len(calls))
    for shape in sorted({tuple(w.q.shape) for _, w in calls}):
        sub = [(x, w) for x, w in calls if tuple(w.q.shape) == shape]
        K, N = shape
        b, by = _dqmm_bound(sub)
        log(f"[time] dequant_matmul M={BATCH} K={K} N={N} x{len(sub)} per step: kernel "
            f"{device_ms(lambda: run(sub), 3) * 1e3:.1f} us, bound {b * 1e3:.1f} us ({by})")

    def dqmm_row(calls, per, reps=3):
        b, by = _dqmm_bound(calls)
        xf = [(x.float(), dense[id(w)]) for x, w in calls]
        row = {"ms": device_ms(lambda: run(calls), reps),
               "plain_ms": device_ms(lambda: run(calls, ref.dequant_matmul_ref), 1),
               "library_ms": device_ms(lambda: [torch.matmul(x, w) for x, w in xf], reps),
               "host_ms": host_ms(lambda: run(calls), reps),
               "bound_ms": b, "bound_by": by, "per": per,
               "route_ms": {k: device_ms(lambda: run(calls, fn), reps)
                            for k, fn in routes.items()}}
        log(f"[time] dequant_matmul per {per}: kernel {row['ms']:.4f} ms on the device "
            f"(by route {', '.join(f'{k} {v:.4f}' for k, v in row['route_ms'].items())}), "
            f"bound {b:.4f} ms ({by}), plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms (torch.matmul on dequantised float32 weights); host "
            f"issue {row['host_ms']:.4f} ms")
        return row

    step = dqmm_row(calls, f"one decode step ({len(calls)} launches at M={BATCH})")
    kern["dequant_matmul"].update(step)
    calls = path_calls(POOL_SLOTS)
    kern["dequant_matmul"]["pool_step"] = dqmm_row(
        calls, f"one pool decode step ({len(calls)} launches at M={POOL_SLOTS})")
    tick_M, prefill_M = POOL_SLOTS * POOL_CHUNK, BATCH * PROMPT
    calls = path_calls(tick_M)
    kern["dequant_matmul"]["tick"] = dqmm_row(
        calls, f"one chunk tick ({len(calls)} launches at M={tick_M})", 2)
    calls = path_calls(prefill_M, unembed=False)
    kern["dequant_matmul"]["prefill"] = dqmm_row(
        calls, f"one prefill's layer weights ({len(calls)} launches at M={prefill_M})", 2)
    del calls

    # both routes at every M, on layer 0's seven weights and on embed.T:
    # the measurements that set dequant_matmul.MMA_MIN_M
    by_m = {}
    for M in DQMM_TIME_M:
        calls = path_calls(M)
        groups = {"layer 0": calls[:7], "embed.T": calls[-1:]}
        by_m[M] = {g: {k: device_ms(lambda: run(sub, fn), 3) for k, fn in routes.items()}
                   for g, sub in groups.items()}
        log(f"[time] dequant_matmul M={M} (route {dqm.route(M, torch.uint16)}): "
            + "; ".join(f"{g} " + ", ".join(f"{k} {t:.4f} ms" for k, t in r.items())
                        for g, r in by_m[M].items()))
    kern["dequant_matmul"]["by_M"] = by_m
    del dense, calls

    # the plane mask's cost: a decode step's 113 launches with keep = 4
    # against the full-width keep, in one call
    calls = path_calls(BATCH)
    keeps = {"keep=4": four, "keep=16": torch.full((1, 1), 16, dtype=torch.int32, device=dev)}
    mask_ms = {}
    for rep_i in range(2):
        for label, kt in keeps.items():
            mask_ms.setdefault(label, []).append(device_ms(lambda: [
                dqm.dequant_matmul(x, w.q, w.scale, w.offset, kt) for x, w in calls], 3))
    log(f"[time] dequant_matmul plane mask, one decode step ({len(calls)} launches at "
        f"M={BATCH}), two turns each: " + ", ".join(f"{k} {v[0]:.4f}, {v[1]:.4f} ms"
                                                   for k, v in mask_ms.items()))
    kern["dequant_matmul"]["mask_ms"] = mask_ms
    del calls
    kern["dequant_matmul"]["verify_step"] = _verify_timings(model, spec["engine"], dev, xg)

    # decode_attention: the decode step's 16 launches, one per layer's cache
    caches = [layer(srv.caches["cycles"]["0_attn"], r) for r in range(layers)]
    valid = (k_pos >= 0) & (k_pos <= q_pos[:, None])
    mask = torch.where(valid, 0.0, -1e30).to(cfg.dtype)[:, None, None, :]
    q4 = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def attend(fn):
        for c in caches:
            fn(c)

    kv_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
    n_b = kv_bytes + 2 * q.numel() * q.element_size() + k_pos.numel() * 4 + BATCH * 4
    n_ops = 4 * BATCH * cfg.n_heads * S * cfg.hd
    b, by = bound_ms(layers * n_b, layers * n_ops, FP32_FLOPS)
    kern["decode_attention"].update(
        ms=device_ms(lambda: attend(lambda c: da.flash_decode(q, c["k"], c["v"], k_pos,
                                                              q_pos)), 5),
        plain_ms=device_ms(lambda: attend(lambda c: ref.flash_decode_ref(
            q, c["k"], c["v"], k_pos, q_pos)), 5),
        library_ms=device_ms(lambda: attend(lambda c: sdpa(q4, c["k"], c["v"],
                                                           attn_mask=mask)), 5),
        host_ms=host_ms(lambda: attend(lambda c: da.flash_decode(q, c["k"], c["v"], k_pos,
                                                                 q_pos)), 5),
        bound_ms=b, bound_by=by, per=f"one decode step ({layers} launches)")

    # flash_verify: one chunk tick's 16 launches, one per layer's pooled cache
    pcaches = [layer(pool.caches["cycles"]["0_attn"], r) for r in range(layers)]
    vvalid = (vk_pos[:, None, :] >= 0) & (vk_pos[:, None, :] <= vq_pos[:, :, None]) \
        & (vq_pos[:, :, None] >= 0)
    vmask = torch.where(vvalid, 0.0, -1e30).to(cfg.dtype)[:, None]   # (B, 1, T, S)
    vq_h = vq.transpose(1, 2)                                         # (B, H, T, hd)

    def attend_tick(fn):
        for c in pcaches:
            fn(c)

    kv_bytes = 2 * pcache["k"].numel() * pcache["k"].element_size()
    n_b = kv_bytes + 2 * vq.numel() * vq.element_size() + vk_pos.numel() * 4 \
        + vq_pos.numel() * 4
    n_ops = 4 * POOL_SLOTS * T * cfg.n_heads * PS * cfg.hd
    b, by = bound_ms(layers * n_b, layers * n_ops, FP32_FLOPS)
    kern["flash_verify"].update(
        ms=device_ms(lambda: attend_tick(lambda c: va.flash_verify(
            vq, c["k"], c["v"], vk_pos, vq_pos)), 5),
        plain_ms=device_ms(lambda: attend_tick(lambda c: ref.flash_verify_ref(
            vq, c["k"], c["v"], vk_pos, vq_pos)), 3),
        library_ms=device_ms(lambda: attend_tick(lambda c: sdpa(
            vq_h, c["k"], c["v"], attn_mask=vmask)), 5),
        host_ms=host_ms(lambda: attend_tick(lambda c: va.flash_verify(
            vq, c["k"], c["v"], vk_pos, vq_pos)), 5),
        bound_ms=b, bound_by=by, per=f"one chunk tick ({layers} launches)")

    # both attention kernels at long caches, where the body's ring cycles
    for S_long in ATTN_LONG_S:
        for name, row in _attention_long(cfg, dev, xg, S_long, da, va, ref).items():
            kern[name].setdefault("by_S", {})[S_long] = row

    # one whole chunk tick of the pool (every slot consuming 8 prompt rows)
    # and its unembedding: the transposed 206 MB embed.T at M = 64
    tick_pos = (torch.arange(POOL_SLOTS, dtype=torch.int32, device=dev)[:, None] * 8
                + torch.arange(T, dtype=torch.int32, device=dev))
    tick_tok = torch.randint(0, cfg.vocab, (POOL_SLOTS, T), generator=xg, device=dev,
                             dtype=torch.int32)
    final = torch.full((POOL_SLOTS,), T - 1, dtype=torch.int32, device=dev)

    def tick():
        _chunk_step(model, pool.params, pool.caches, tick_tok, tick_pos, final, pool.pos,
                    pool.last_logits, pool._last_tok, pool._first_cap)

    emb = pool.params["embed"].T
    x64 = torch.randn((POOL_SLOTS * T, cfg.d_model), generator=xg, device=dev)
    tick_ms, tick_host_ms = device_ms(tick, 2), host_ms(tick, 3)
    unembed = {k: device_ms(lambda: fn(x64, emb.q, emb.scale, emb.offset), 5)
               for k, fn in routes.items()}
    unembed_bound, by = _dqmm_bound([(x64, emb)])
    log(f"[time] pool chunk tick ({POOL_SLOTS} slots x {T} rows, all live): "
        f"{tick_ms:.3f} ms on the device, host issue {tick_host_ms:.3f} ms; its "
        f"unembedding (dequant_matmul M={x64.shape[0]} on embed.T {tuple(emb.q.shape)}, "
        f"float32 x) on the device: " + ", ".join(f"{k} {t:.4f} ms" for k, t in unembed.items())
        + f", bound {unembed_bound:.4f} ms ({by})")

    # the single stream's prefill alone: a (BATCH, PROMPT) prompt at stage 8
    prompt_dev = prompt.to(dev)
    prefill_ms = device_ms(lambda: model.prefill(srv.params, {"tokens": prompt_dev}), 1)
    prefill_host_ms = host_ms(lambda: model.prefill(srv.params, {"tokens": prompt_dev}), 1)
    log(f"[time] single-stream prefill ({BATCH} x {PROMPT} tokens, stage 8): "
        f"{prefill_ms:.3f} ms on the device, host issue {prefill_host_ms:.3f} ms")

    sources = {"plane_or_segments": ("plane_or.cu", "src/repro/kernels/bitplane.py:89"),
               "dequant_matmul": ("dequant_matmul.cu",
                                  "src/repro/kernels/dequant_matmul.py:70"),
               "decode_attention": ("decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:101"),
               "flash_verify": ("verify_attention.cu",
                                "src/repro/kernels/verify_attention.py:91"),
               "plane_or": ("plane_or.cu", "src/repro/kernels/bitplane.py:53"),
               "plane_extract": ("plane_extract.cu", "src/repro/kernels/bitplane.py:149")}
    # launches on the main paths, each path counted from 0
    paths = {"divide": divide_counts, "serve": path_counts, "pool": pool_counts,
             "spec": spec["counts"], "spec pool": spec_pool["counts"],
             "wire": wire_counts, "session": session["counts"],
             "upgrade per tensor": upgrade_counts}
    launches = {name: sum(c.get(name, 0) for c in paths.values()) for name in sources}
    check(all(launches[name] > 0 for name in sources), launches)
    # dequant_matmul's launches by route on the paths that run it
    route_paths = {"serve": serve_routes, "pool": pool_routes, "spec": spec["routes"],
                   "spec pool": spec_pool["routes"], "wire": wire_routes,
                   "session": session["routes"]}
    by_route = {k: sum(r[k] for r in route_paths.values()) for k in dqm.launches_by_route}
    check(sum(by_route.values()) == launches["dequant_matmul"] and all(by_route.values()),
          (by_route, launches["dequant_matmul"]))
    log(f"[time] dequant_matmul launches by route on the paths: {by_route} ("
        + ", ".join(f"{p} {r}" for p, r in route_paths.items()) + ")")
    dq = kern["dequant_matmul"]
    dq["launches_by_route"] = by_route
    # one entry a CUDA kernel: dequant_matmul's launches are its GEMV
    # kernel's, the tensor-core kernel's are dequant_matmul_mma's (the
    # wrapper's count, ops.LAUNCH_COUNTS["dequant_matmul"], is their sum);
    # the tensor-core kernel's row is the chunk tick
    kern["dequant_matmul_mma"] = {**dq["tick"], "max_abs_err": route_err["mma"]}
    sources["dequant_matmul_mma"] = ("dequant_matmul_mma.cu",
                                     "src/repro/kernels/dequant_matmul.py:70")
    launches["dequant_matmul"], launches["dequant_matmul_mma"] = by_route["gemv"], by_route["mma"]
    line = []
    for name, (src, replaces) in sources.items():
        k = kern[name]
        dq_route = {"dequant_matmul": "gemv", "dequant_matmul_mma": "mma"}.get(name)
        per_path = ({p: r[dq_route] for p, r in route_paths.items()} if dq_route
                    else {p: c.get(name, 0) for p, c in paths.items()})
        log(f"[time] {name} per {k['per']}: kernel {k['ms']:.4f} ms on the device, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms; host issue {k['host_ms']:.4f} ms; "
            f"launches on the paths {launches[name]} ("
            + ", ".join(f"{p} {n}" for p, n in per_path.items()) + ")")
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                 "launches": launches[name], "max_abs_err": k["max_abs_err"],
                 "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                 "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        if name == "dequant_matmul":
            entry.update({key: dq[key] for key in ("launches_by_route", "pool_step", "tick",
                                                   "prefill", "by_M", "keep_checked",
                                                   "keep_max_rel_err", "keep_max_abs_err",
                                                   "mask_ms", "verify_step")})
        if "by_S" in k:
            entry["by_S"] = k["by_S"]
        line.append(entry)
    log(f"[done] {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _divide_phase(model, dev, ops):
    """``[divide]``: random full-width weights split into planes on the
    card, counted from 0; then the in-memory receiver through all 8
    stages, its fingerprint after each (the wire phase's reference), and
    its stage-8 accumulators against ``quantize(leaf).q`` of every tensor;
    every plane of the largest tensor against the plain version. Returns
    the divided model, the parameter count, the 8 fingerprints and the
    path's launch counts."""
    from repro_torch.core.bitplanes import concat
    from repro_torch.core.progressive import ReceiverState, divide, tree_flatten_with_path
    from repro_torch.core.quantize import quantize
    from repro_torch.kernels import bitplane, ref

    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = dict(tree_flatten_with_path(params))
    n_params = sum(t.numel() for t in leaves.values())
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    reset_counts(ops)
    t0 = time.perf_counter()
    prog = divide(params)
    torch.cuda.synchronize()
    t_divide = time.perf_counter() - t0
    run_counts, op_counts = counts(), dict(ops.LAUNCH_COUNTS)
    n_t = len(prog.tensors)
    check(run_counts["plane_extract"] == op_counts["plane_extract"] == 8 * n_t,
          (run_counts, n_t))
    check(sum(run_counts.values()) == 8 * n_t and op_counts == {"plane_extract": 8 * n_t},
          (run_counts, op_counts))
    log(f"[divide] olmo-1b full width: {n_params} parameters, {n_t} tensors, "
        f"{prog.n_stages} stages of 2-bit planes; init {t_init:.1f} s, divide on the card "
        f"{t_divide:.2f} s; launches {run_counts}")

    state = ReceiverState.init(prog, device=dev)
    fps = []
    for s in range(1, prog.n_stages + 1):
        state = state.receive(prog.stage(s))
        fps.append(state.store.fingerprint())
    for i, t in enumerate(prog.tensors):
        check(torch.equal(state.store._slice_acc(i), quantize(leaves[t.path], 16).q),
              f"stage-8 accumulator of {t.path} differs from quantize(leaf).q")
    del state
    big = max(prog.tensors, key=lambda t: int(np.prod(t.shape)))
    q = quantize(leaves[big.path], 16).q
    before = 0
    for w, p in zip(big.plan.schedule.widths, big.planes):
        got = bitplane.plane_extract(q, bits=16, before=before, width=w, out_dtype=torch.uint8)
        check(torch.equal(got, ref.plane_extract_ref(q, 16, before, w, torch.uint8))
              and torch.equal(got, p), f"plane at {before} of {big.path}")
        before += w
    wide = bitplane.plane_extract(q, bits=16, before=3, width=9)
    check(torch.equal(wide, ref.plane_extract_ref(q, 16, 3, 9)), "uint16 plane")
    check(torch.equal(concat(big.planes, 16, big.plan.schedule.widths), q),
          "concat of the planes differs from q")
    log(f"[divide] stage-8 accumulators equal quantize(leaf).q of all {n_t} tensors, bit "
        f"for bit; fingerprints after each stage {[fp['uint16'] for fp in fps]}; the 8 "
        f"planes of {'/'.join(big.path)} {tuple(big.shape)} (and a 9-bit uint16 plane) "
        f"equal the plain version, and concat of them (plane_or) restores its q")
    del params, leaves, q
    return prog, n_params, fps, run_counts


def _ragged(rng) -> int:
    """A chunk size, log-uniform from 1 byte to CHUNK_MAX."""
    return int(np.exp(rng.uniform(0.0, np.log(CHUNK_MAX))))


def _feeder(client, blob, seed):
    """``feed_to(end)`` feeds the next bytes of ``blob`` up to ``end`` in
    seeded ragged chunks and returns the host seconds it took."""
    view, rng, fed = memoryview(blob), np.random.default_rng(seed), [0]

    def feed_to(end: int) -> float:
        t0 = time.perf_counter()
        pos = fed[0]
        while pos < end:
            n = min(end - pos, _ragged(rng))
            client.feed(view[pos:pos + n])
            pos += n
        fed[0] = end
        return time.perf_counter() - t0

    return feed_to


def _stage_ends(wire, blob) -> tuple[dict, list[int]]:
    meta, hdr = wire.decode_header(blob)
    ends = [hdr]
    for n in wire.layout_from_header(meta, hdr).stage_bytes:
        ends.append(ends[-1] + n)
    return meta, ends


def _wire_phase(model, prog, dev, ops, prompt, res, clean_fps, serve_routes) -> tuple:
    """``[wire]``: the single stream of phase 3 served from v3 wire bytes
    through a CUDA ProgressiveClient, counted from 0 (encode, feed,
    ingest, serve); then a damaged unit on a second feed. Returns the
    path's launch counts and ``dequant_matmul``'s launches by route, which
    equal the in-memory server's."""
    from repro_torch.core import wire
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    n_el = sum(t.planes[0].numel() for t in prog.tensors)
    reset_counts(ops)
    t0 = time.perf_counter()
    blob = wire.encode(prog, integrity=True)
    t_encode = time.perf_counter() - t0
    meta, ends = _stage_ends(wire, blob)
    n_units = len(meta["units"])
    check(ends[-1] == len(blob) and len(meta["checkpoints"]) == 8, (ends[-1], len(blob)))
    # the quantized model's 16 bits a weight, plus the v3 frames only
    check(len(blob) - ends[0] == 2 * n_el + n_units * wire.FRAME_BYTES_V3,
          (len(blob), ends[0], n_el, n_units))
    log(f"[wire] encode v3 {t_encode:.2f} s: {len(blob)} bytes, header {ends[0]}, "
        f"{n_units} units, framing {wire.framing_overhead(meta)['overhead_bytes']} bytes")

    snaps = []
    client = ProgressiveClient(on_stage_complete=lambda s: snaps.append(client.store.copy()),
                               device=dev)
    feed_to = _feeder(client, blob, 5)
    feed_s = [feed_to(ends[1])]
    checked = FiniteLogits(model)
    srv = ProgressiveServer(checked, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev, receiver=WireStoreReceiver(client, prog))

    def arrive(i: int) -> bool:
        if i not in ARRIVALS:
            return False
        feed_s.append(feed_to(ends[client.stages_complete + 1]))
        return True

    srv.receive_stage()
    srv.start({"tokens": prompt})
    wres = srv.decode(STEPS, stage_arrival=arrive)
    torch.cuda.synchronize()
    run_counts, op_counts, routes = counts(), dict(ops.LAUNCH_COUNTS), route_counts()
    gemv_by = check_one_pass(routes, "wire")
    decode_s = sum(s for _, s in wres.window_s)
    check(client.complete and client.bytes_fed == len(blob) and srv.stage == 8)
    check(wres.upgrades == res.upgrades, (wres.upgrades, res.upgrades))
    check(torch.equal(wres.tokens, res.tokens), "wire-fed tokens differ from phase 3's")
    check(bool(torch.stack(checked.flags).all()), "non-finite wire-fed logits")
    check(srv.resident_report()["fp_bytes"] == 0)
    check(run_counts["plane_or_segments"] == op_counts["plane_or_segments"] == 8, run_counts)
    check(run_counts["dequant_matmul"] > 0 and run_counts["decode_attention"] > 0
          and run_counts["plane_extract"] == run_counts["plane_or"] == 0, run_counts)
    check(routes == serve_routes, (routes, serve_routes))
    got = [st.fingerprint() for st in snaps]
    check(got == clean_fps, "wire-fed store fingerprints differ from the in-memory ones")
    del snaps
    log(f"[wire] fed in seeded ragged chunks of 1 B to {CHUNK_MAX >> 20} MB, one stage at "
        f"each arrival: host feed s per stage {[round(f, 3) for f in feed_s]}, "
        f"{len(blob) / sum(feed_s) / 1e9:.3f} GB/s; store fingerprint equal to the "
        f"in-memory receiver's after each of the 8 stages")
    log(f"[wire] served: {STEPS} steps x {BATCH} with 7 upgrades and the feeding in "
        f"{decode_s:.3f} s, {BATCH * STEPS / decode_s:.1f} tokens/s; tokens equal "
        f"(torch.equal) to the in-memory server's; launches {run_counts}, dequant_matmul "
        f"by route {routes}, GEMV route by kernel {gemv_by}; health "
        f"{srv._receiver.transport_health()}")
    del srv, client

    # a second feed with one byte of a stage-3 unit flipped
    seq = meta["checkpoints"][1] + int(np.argmax(meta["unit_bytes"][meta["checkpoints"][1]:
                                                                   meta["checkpoints"][2]]))
    layout = wire.layout_from_header(meta, ends[0])
    o = layout.unit_offsets()[seq]
    e = o + meta["unit_bytes"][seq]
    flip = o + (e - o) // 2
    client = ProgressiveClient(device=dev)
    feed = _feeder(client, blob, 6)
    feed(ends[0])
    ingest_ms, orig = [], client.store.ingest

    def timed_ingest(items):
        torch.cuda.synchronize()
        t = time.perf_counter()
        orig(items)
        torch.cuda.synchronize()
        ingest_ms.append((time.perf_counter() - t) * 1e3)

    client.store.ingest = timed_ingest
    feed(flip)
    client.feed(bytes([blob[flip] ^ 0x20]))
    _feeder(client, memoryview(blob)[flip + 1:], 7)(len(blob) - flip - 1)
    check(client.stages_complete == 2 and not client.complete, client.stages_complete)
    check(list(client.nacks) == [seq] and client.quarantine_log[0]["seq"] == seq,
          client.quarantine_log)
    check(client.store.fingerprint() == clean_fps[1], "damaged stream diverged at stage 2")
    check(client.feed_repair(seq, memoryview(blob)[o:e]), "repair refused")
    check(client.complete and not client.nacks, client.nacks)
    check(client.store.fingerprint() == clean_fps[-1], "repaired store differs")
    log(f"[wire] unit {seq} of stage 3 ({e - o} bytes) damaged: quarantined "
        f"({client.quarantine_log[0]['reason'][:40]}...), stages held at 2 with the "
        f"clean stage-2 fingerprint; after feed_repair all 8 stages, fingerprint equal to "
        f"the clean one; ingest ms a stage (synchronised) "
        f"{[round(t, 2) for t in ingest_ms]}")
    return run_counts, routes


def _wire_v1_check(cfg, dev) -> None:
    """Raw v1 bytes of the 2-layer full-width model through a CUDA client:
    fingerprints after every stage equal the in-memory receiver's, and the
    wire-fed server's tokens equal the pull-mode server's."""
    from repro_torch.core import wire
    from repro_torch.core.progressive import ReceiverState, divide
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    model = build_model(dataclasses.replace(cfg, n_layers=2))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(3), device=dev))
    blob = wire.encode(prog)
    meta, ends = _stage_ends(wire, blob)
    check(meta["version"] == 1 and ends[-1] == len(blob))
    fps = []
    client = ProgressiveClient(on_stage_complete=lambda s: fps.append(
        client.store.fingerprint()), device=dev)
    feed_to = _feeder(client, blob, 8)
    feed_to(ends[1])
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(4))
    steps, arrivals = 16, set(range(1, 15, 2))
    wired = ProgressiveServer(model, prog, max_len=32, resident="quantized", device=dev,
                              receiver=WireStoreReceiver(client, prog))
    pull = ProgressiveServer(model, prog, max_len=32, resident="quantized", device=dev)
    for srv in (wired, pull):
        srv.receive_stage()
        srv.start({"tokens": prompt})

    def arrive(i: int) -> bool:
        if i not in arrivals:
            return False
        feed_to(ends[client.stages_complete + 1])
        return True

    got = wired.decode(steps, stage_arrival=arrive)
    want = pull.decode(steps, stage_arrival=lambda i: i in arrivals)
    check(client.complete and wired.stage == pull.stage == 8)
    check(torch.equal(got.tokens, want.tokens), "v1 wire-fed tokens differ")
    state = ReceiverState.init(prog, device=dev)
    for s in range(8):
        state = state.receive(prog.stage(s + 1))
        check(state.store.fingerprint() == fps[s], f"v1 stage {s + 1} fingerprint")
    log(f"[wire] raw v1, 2-layer full width: {len(blob)} bytes in ragged chunks; "
        f"fingerprints equal the in-memory receiver's after each of the 8 stages; "
        f"{steps} x 2 tokens equal (torch.equal) to the pull-mode server's")


class LogitLog:
    """Wraps a Model: keeps, on the device, the logits of the prefill and
    of every decode step, in order."""

    def __init__(self, model):
        self.model = model
        self.logits: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, batch):
        last, caches = self.model.prefill(params, batch)
        self.logits.append(last)
        return last, caches

    def decode_step(self, params, caches, tokens, pos):
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.logits.append(logits)
        return logits, caches


def _counted(ops, fn, acc: dict, routes: dict):
    """Run ``fn()`` with the launch counts set to 0 just before and read
    just after; add them into ``acc`` and ``routes``. Returns ``fn()``'s
    result and this run's counts."""
    torch.cuda.synchronize()
    reset_counts(ops)
    out = fn()
    torch.cuda.synchronize()
    got, by = counts(), route_counts()
    if by["gemv"]:
        check_one_pass(by, "session")
    for k, v in got.items():
        acc[k] = acc.get(k, 0) + v
    for k, v in by.items():
        routes[k] = routes.get(k, 0) + v
    return out, got


def _fp_against_quantized(fp_logits, q_logits, fp_tokens, q_tokens) -> tuple[float, int, int]:
    """Hold the float-resident run to the quantized-resident one, step by
    step and row by row while the row's tokens so far agree: logits within
    ``FP_LOGIT_RTOL`` of the largest quantized logit, and the greedy token
    equal wherever the quantized logits' top two are further apart than
    twice that. Returns the worst relative error, the tokens checked and
    the tokens whose margin did not clear the tolerance."""
    worst, checked, near = 0.0, 0, 0
    B = fp_tokens.shape[0]
    live = [True] * B
    # step i's logits choose token i (the prefill's choose token 0)
    for i in range(fp_tokens.shape[1]):
        fl, ql = fp_logits[i].float(), q_logits[i].float()
        for b in range(B):
            if not live[b]:
                continue
            mag = float(ql[b].abs().max())
            err = float((fl[b] - ql[b]).abs().max())
            check(err <= FP_LOGIT_RTOL * mag, ("fp logits", i, b, err, mag))
            worst = max(worst, err / mag)
            top2 = torch.topk(ql[b], 2).values
            if float(top2[0] - top2[1]) > 2 * FP_LOGIT_RTOL * mag:
                check(int(fp_tokens[b, i]) == int(q_tokens[b, i]), ("fp token", i, b))
                checked += 1
            else:
                near += 1
                if int(fp_tokens[b, i]) != int(q_tokens[b, i]):
                    live[b] = False
    return worst, checked, near


def _replay_wire(model, prog, blob, ends, prompt, stage_at_step, dev):
    """A quantized-resident ``ProgressiveServer(receiver=)`` over a fresh
    client fed whole stages, upgraded to each step's stage of
    ``stage_at_step``."""
    from repro_torch.serving.engine import ProgressiveServer, WireStoreReceiver
    from repro_torch.transmission import ProgressiveClient

    client = ProgressiveClient(device=dev)
    view, fed = memoryview(blob), [0]

    def feed_to(s):
        client.feed(view[fed[0]:ends[s]])
        fed[0] = ends[s]

    srv = ProgressiveServer(model, prog, max_len=prompt.shape[1] + len(stage_at_step),
                            resident="quantized", device=dev,
                            receiver=WireStoreReceiver(client, prog))
    feed_to(stage_at_step[0])
    srv.receive_stage()
    srv.start({"tokens": prompt})

    def arrive(i: int) -> bool:
        if stage_at_step[i] <= srv.stage:
            return False
        feed_to(stage_at_step[i])
        return True

    res = srv.decode(len(stage_at_step), stage_arrival=arrive)
    check(res.stage_at_step == list(stage_at_step), (res.stage_at_step, stage_at_step))
    return res.tokens


def _session_phase(model, prog, dev, ops, prompt, clean_fps) -> dict:
    """``[session]``: the byte-clock ``Session`` on full-width olmo-1b over
    ``pod-coldstart`` (200 MB/s, 1 MB chunks): ``run_timeline``;
    ``run_serving`` in quantized and float residency; a faulted run on
    the v3 wire (the CLI's default profile) with its recovery proved;
    ``run_serving_pool``. Each run counted from 0; the counts of all of
    them are the path's. Returns the path's counts and routes."""
    from repro_torch.core import wire
    from repro_torch.launch.serve import _verify_fault_recovery
    from repro_torch.serving.engine import ProgressiveServer
    from repro_torch.transmission import (FaultPolicy, FaultTrace, Link, Session, StageCost,
                                          flash_crowd_arrivals, get_scenario,
                                          progressive_timeline)

    cfg, layers = model.cfg, model.cfg.n_layers
    acc, routes = {}, {}
    scenario = get_scenario(SESSION_SCENARIO)
    t0 = time.perf_counter()
    blob = wire.encode(prog)
    t_encode = time.perf_counter() - t0
    meta, ends = _stage_ends(wire, blob)
    session = Session.from_scenario(blob, scenario, seed=0, device=dev)
    n_pieces = len(session._pieces())
    log(f"[session] {SESSION_SCENARIO}: v1 stream {len(blob)} bytes (encode {t_encode:.2f} "
        f"s), {n_pieces} feeds of <= {scenario.chunk_bytes} bytes; simulated stage arrivals "
        f"{[round(a, 4) for a in session.stage_arrival_times()]} s")

    # run_timeline: the client alone on the byte clock, against the algebra
    costs = [StageCost(*SESSION_STAGE_COST)] * prog.n_stages
    t0 = time.perf_counter()
    tl, c = _counted(ops, lambda: session.run_timeline(costs), acc, routes)
    host_s = time.perf_counter() - t0
    feeds = len(tl.events_of("chunk"))
    check(c["plane_or_segments"] == 8 and sum(c.values()) == 8, c)
    check(tl.client.store.fingerprint() == clean_fps[-1], "timeline store differs")
    want = progressive_timeline(session.layout.stage_bytes,
                                Link(bandwidth_bytes_per_s=200e6, latency_s=scenario.latency_s),
                                costs, concurrent=True, header_bytes=session.layout.header_bytes)
    gap = max(abs(a - b) for a, b in zip(tl.timeline.download_done + tl.timeline.result_ready,
                                          want.download_done + want.result_ready))
    check(gap < 1e-9, ("timeline against the algebra", gap))
    feed_ms = host_s / feeds * 1e3
    log(f"[session] run_timeline: {feeds} feeds, {len(tl.events)} events; host {host_s:.3f} "
        f"s, {feed_ms:.4f} ms a feed, {len(blob) / host_s / 1e9:.3f} GB/s; simulated "
        f"download_done {[round(t, 4) for t in tl.timeline.download_done]} s, result_ready "
        f"(stage cost {SESSION_STAGE_COST} s, simulated) "
        f"{[round(t, 4) for t in tl.timeline.result_ready]} s; within {gap:.1e} s of "
        f"progressive_timeline; store fingerprint equal to the in-memory receiver's")
    del tl

    arrivals_clean = session.stage_arrival_times()
    # run_serving, quantized then float residency, on the same byte clock
    runs, logs = {}, {}
    for resident in ("quantized", "fp"):
        logs[resident] = LogitLog(model)
        t0 = time.perf_counter()
        r, c = _counted(ops, lambda: session.run_serving(
            logs[resident], prog, decode_steps=SESSION_STEPS, batch={"tokens": prompt},
            resident=resident), acc, routes)
        r.host_s = time.perf_counter() - t0
        runs[resident] = (r, c)
        check(r.tokens.shape == (BATCH, SESSION_STEPS) and r.server.stage == 8, r.upgrades)
        check(c["plane_or_segments"] == 8 and c["decode_attention"] == layers * SESSION_STEPS,
              c)
        check(r.client.store.fingerprint() == clean_fps[-1], f"{resident} store differs")
        log(f"[session] run_serving {resident}: {SESSION_STEPS} steps x {BATCH}, upgrades "
            f"(step, stage) {r.upgrades}; {len(r.events)} events; host {r.host_s:.3f} s; "
            f"launches {c}")
    (q, qc), (f, fc) = runs["quantized"], runs["fp"]
    check(qc["dequant_matmul"] == (layers * 7 + 1) * (1 + SESSION_STEPS), qc)
    check(fc["dequant_matmul"] == 0, fc)
    check(q.stage_at_step == f.stage_at_step and q.upgrades == f.upgrades)
    check(q.upgrades and q.stage_at_step[0] < 8 <= q.stage_at_step[-1], q.stage_at_step)
    q_events = [(e.t_s, e.kind) for e in q.events]
    check(q_events == [(e.t_s, e.kind) for e in f.events], "the two runs' byte clocks differ")
    replay = _replay_wire(model, prog, blob, ends, prompt, q.stage_at_step, dev)
    check(torch.equal(replay, q.tokens), "quantized session tokens differ from the replay")
    worst, n_checked, n_near = _fp_against_quantized(
        logs["fp"].logits, logs["quantized"].logits, f.tokens, q.tokens)
    same = int((f.tokens == q.tokens).sum())
    log(f"[session] quantized tokens equal (torch.equal) to a ProgressiveServer(receiver=) "
        f"replay at the run's stage_at_step; float-resident logits within {worst:.3e} of "
        f"the largest quantized logit (tolerance {FP_LOGIT_RTOL}), greedy tokens equal at "
        f"all {n_checked} positions whose top-two margin clears twice that ({n_near} "
        f"within it); {same}/{f.tokens.numel()} tokens equal overall")
    del logs

    # decode rate of both residencies at stage 8, and the float upgrade
    rates = {"quantized": [], "fp": []}
    for _ in range(2):
        for resident, (r, _) in runs.items():
            srv = r.server
            srv.start({"tokens": prompt})
            res = srv.decode(SESSION_STEPS)
            rates[resident].append(BATCH * SESSION_STEPS / sum(s for _, s in res.window_s))
    reports = {k: r.server.resident_report() for k, (r, _) in runs.items()}
    store_bytes = runs["fp"][0].client.store.resident_bytes()
    check(reports["quantized"]["fp_bytes"] == 0 and reports["fp"]["quantized_bytes"] == 0)
    store = runs["fp"][0].client.store
    n_w = sum(t.size for t in store.slots)
    up_ms, up_dev = [], []
    for _ in range(3):
        store._dirty.update(range(store.n_tensors))
        store._leaf_cache.clear()
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        store.materialize_leaves()
        e1.record()
        torch.cuda.synchronize()
        up_ms.append((time.perf_counter() - t0) * 1e3)
        up_dev.append(e0.elapsed_time(e1))
    up_bound = (2 * n_w + 4 * n_w) / HBM_BYTES_PER_S * 1e3
    log(f"[session] decode at stage 8 ({BATCH} x {SESSION_STEPS}), in turns: quantized "
        f"{[round(x, 2) for x in rates['quantized']]} tokens/s, fp "
        f"{[round(x, 2) for x in rates['fp']]} tokens/s; resident bytes quantized "
        f"{reports['quantized']['quantized_bytes']} uint + {reports['quantized']['fp_bytes']} "
        f"fp, fp {reports['fp']['fp_bytes']} float leaves beside the store's {store_bytes} "
        f"accumulator bytes")
    log(f"[session] fp upgrade (dequantize all {store.n_tensors} tensors, {n_w} weights, "
        f"uint16 -> float32): host ms {[round(x, 2) for x in up_ms]}, device ms (events) "
        f"{[round(x, 3) for x in up_dev]}, bound {up_bound:.3f} ms (bytes: q read once, "
        f"leaves written once)")
    del runs, session, store
    torch.cuda.empty_cache()

    # a faulted run on the v3 wire: the CLI's default profile
    blob3 = wire.encode(prog, integrity=True)
    s3 = Session.from_scenario(blob3, scenario, seed=0, device=dev)
    faults = FaultTrace(seed=0, p_corrupt=0.01, p_disconnect=0.002)
    t0 = time.perf_counter()
    fr, c = _counted(ops, lambda: s3.run_serving(
        model, prog, decode_steps=SESSION_STEPS, batch={"tokens": prompt},
        resident="quantized", faults=faults, fault_policy=FaultPolicy(seed=0)), acc, routes)
    host_s = time.perf_counter() - t0
    check(fr.client.complete and not fr.client.nacks, fr.transport)
    check(fr.client.store.fingerprint() == clean_fps[-1], "faulted store differs")
    check(sum(fr.transport["injected"].values()) > 0, fr.transport)
    log(f"[session] faulted run ({SESSION_SCENARIO}, default profile {faults}): "
        f"{fr.transport}; host {host_s:.3f} s; cold start at simulated "
        f"{fr.events_of('cold_start')[0].t_s:.4f} s (clean {arrivals_clean[0]:.4f} s), "
        f"stages served {fr.stage_at_step[0]}-{fr.stage_at_step[-1]}, upgrades "
        f"{fr.upgrades}; launches {c}")
    _verify_fault_recovery(fr, blob3, model, prog, {"tokens": prompt}, device=dev)
    del fr, s3, blob3
    torch.cuda.empty_cache()

    # the pool over the same link: 12 requests joining within 2 s, a
    # simulated round every 1/SESSION_POOL_ROUNDS of the download (the
    # default, a round a token of the whole budget, would end the run
    # before stage 3: 8 slots emit 8 tokens a round)
    lengths, budgets, prompts = _pool_requests(cfg)
    offs = flash_crowd_arrivals(0, POOL_REQUESTS, span_s=2.0)
    session = Session.from_scenario(blob, scenario, seed=0, device=dev)
    arrivals = session.stage_arrival_times()
    step_s = (arrivals[-1] - arrivals[0]) / SESSION_POOL_ROUNDS
    t0 = time.perf_counter()
    pr, c = _counted(ops, lambda: session.run_serving_pool(
        model, prog, prompts=prompts, arrival_offsets_s=offs, max_new_tokens=SESSION_POOL_TOKENS,
        n_slots=POOL_SLOTS, resident="quantized", dispatch_window=POOL_WINDOW,
        step_time_s=step_s), acc, routes)
    host_s = time.perf_counter() - t0
    pool = pr.server
    check(sorted(pr.tokens) == list(range(POOL_REQUESTS)), sorted(pr.tokens))
    check(all(len(v) == SESSION_POOL_TOKENS and all(0 <= t < cfg.vocab for t in v)
              for v in pr.tokens.values()))
    check(pool.stage == 8 and len(pr.upgrades) > 0, pr.upgrades)
    ticks, steps = pool._tick_count, pool._step_count
    check(c["plane_or_segments"] == 8 and c["flash_verify"] == layers * ticks
          and c["decode_attention"] == layers * steps
          and c["dequant_matmul"] == (layers * 7 + 1) * (ticks + steps), (c, ticks, steps))
    log(f"[session] run_serving_pool: {POOL_REQUESTS} requests over 2 s into {POOL_SLOTS} "
        f"slots, {SESSION_POOL_TOKENS} tokens each; admissions at simulated "
        f"{[round(t, 3) for t, _ in pr.admissions]} s; upgrades {pr.upgrades}; {ticks} "
        f"ticks, {steps} steps; host {host_s:.3f} s; launches {c}")
    del pr, pool, session, blob
    torch.cuda.empty_cache()
    return {"counts": acc, "routes": routes, "feed_ms": feed_ms}


def _session_small(cfg, dev, ops, acc: dict, routes: dict) -> None:
    """``[session]`` on the 2-layer full-width model (475 MB on the v1
    wire): ``run_timeline`` over each small-chunk scenario (16-32 KB
    chunks: 14,489-28,969 feeds), ``run_serving`` over
    ``browser-lte-handoff`` against a stage replay, and the lossy
    scenarios on the v3 wire, which end in ``TransportError``; then the
    lossy scenarios on reduced olmo-1b, recovered. Counted into ``acc``
    and ``routes``."""
    from repro_torch.core import wire
    from repro_torch.core.progressive import ReceiverState, divide
    from repro_torch.models.model import build_model
    from repro_torch.transmission import (FaultPolicy, Session, StageCost, TransportError,
                                          get_scenario)

    model = build_model(dataclasses.replace(cfg, n_layers=2))
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(3), device=dev))
    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages + 1):
        state = state.receive(prog.stage(s))
    clean = state.store.fingerprint()
    del state
    blob = wire.encode(prog)
    _, ends = _stage_ends(wire, blob)
    costs = [StageCost(*SESSION_STAGE_COST)] * prog.n_stages
    for name in SMALL_CHUNK_SCENARIOS:
        session = Session.from_scenario(blob, get_scenario(name), seed=0, device=dev)
        t0 = time.perf_counter()
        tl, c = _counted(ops, lambda: session.run_timeline(costs), acc, routes)
        host_s = time.perf_counter() - t0
        feeds = len(tl.events_of("chunk"))
        check(c["plane_or_segments"] == 8 and tl.client.store.fingerprint() == clean, (name, c))
        log(f"[session] 2-layer, {name} ({session.chunk_bytes} B chunks): run_timeline "
            f"{feeds} feeds, host {host_s:.3f} s, {host_s / feeds * 1e3:.4f} ms a feed; "
            f"simulated download_done {[round(t, 2) for t in tl.timeline.download_done]} s; "
            f"fingerprint equal to the in-memory receiver's")
    prompt = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(4))
    session = Session.from_scenario(blob, get_scenario("browser-lte-handoff"), seed=1,
                                    device=dev)
    r, c = _counted(ops, lambda: session.run_serving(
        model, prog, decode_steps=32, batch={"tokens": prompt}, resident="quantized"),
        acc, routes)
    check(r.server.stage == 8 and len(r.upgrades) > 1, r.upgrades)
    replay = _replay_wire(model, prog, blob, ends, prompt, r.stage_at_step, dev)
    check(torch.equal(replay, r.tokens), "2-layer session tokens differ from the replay")
    log(f"[session] 2-layer, browser-lte-handoff: run_serving quantized, 32 steps x 2, "
        f"upgrades {r.upgrades}, tokens equal (torch.equal) to a stage replay; launches {c}")
    # the lossy scenarios repair whole v3 units; here a unit is a whole
    # plane of a tensor (2-26 MB), which 1% corruption a chunk almost
    # never lets through intact, so the transport must give up with its
    # typed error, before serving anything
    blob3 = wire.encode(prog, integrity=True)
    for name in LOSSY_SCENARIOS:
        sc = get_scenario(name)
        session = Session.from_scenario(blob3, sc, seed=0, device=dev)
        t0 = time.perf_counter()
        err = None
        try:
            session.run_serving(model, prog, decode_steps=16, batch={"tokens": prompt},
                                resident="quantized", faults=sc.make_faults(0),
                                fault_policy=FaultPolicy(seed=0))
        except TransportError as e:
            err = e
        check(err is not None, f"{name} on the 2-layer model: expected a TransportError")
        log(f"[session] 2-layer, {name}: TransportError, as the unit sizes predict, after "
            f"{time.perf_counter() - t0:.1f} s: {err}")
    del blob3, blob, prog, model
    torch.cuda.empty_cache()

    # the lossy scenarios where a unit is small enough to cross the
    # channel: reduced olmo-1b (d_model 128), both residencies' fault
    # recovery proved as the CLI proves it
    from repro_torch.launch.serve import _verify_fault_recovery

    small = build_model(cfg.reduced())
    sprog = divide(small.init(torch.Generator(device=dev).manual_seed(5), device=dev))
    blob3 = wire.encode(sprog, integrity=True)
    sprompt = torch.randint(0, small.cfg.vocab, (2, 16),
                            generator=torch.Generator().manual_seed(6))
    for name in LOSSY_SCENARIOS:
        sc = get_scenario(name)
        session = Session.from_scenario(blob3, sc, seed=0, device=dev)
        t0 = time.perf_counter()
        r, c = _counted(ops, lambda: session.run_serving(
            small, sprog, decode_steps=16, batch={"tokens": sprompt}, resident="quantized",
            faults=sc.make_faults(0), fault_policy=FaultPolicy(seed=0)), acc, routes)
        host_s = time.perf_counter() - t0
        check(sum(r.transport["injected"].values()) > 0, r.transport)
        _verify_fault_recovery(r, blob3, small, sprog, {"tokens": sprompt}, device=dev)
        log(f"[session] reduced olmo-1b ({len(blob3)} B v3), {name}: {r.transport}; "
            f"upgrades {r.upgrades}; host {host_s:.3f} s; launches {c}")


def _cli_phase() -> None:
    """The CLI at full width as a process of its own: ``python -m
    repro_torch.launch.serve --arch olmo-1b --scenario pod-coldstart``,
    every other flag at its default (float residency, batch 2, prompt 32,
    64 decode steps)."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "olmo-1b",
           "--scenario", "pod-coldstart"]
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CLI_TIMEOUT_S,
                          env=env, cwd=ROOT)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, ("cli", proc.returncode, proc.stderr[-3000:]))
    out = proc.stdout.strip().splitlines()
    check(out and out[-1].startswith("served 64 steps across 8 precision stages"), out[-3:])
    for line in out:
        log(f"[cli] {line[:300]}")
    log(f"[cli] {' '.join(cmd[1:])}: exit 0 in {wall:.1f} s")


def _upgrade_phase(prog, dev, ops):
    """``[upgrade per tensor]``: the store after stage 7; stage 8 as one
    ``plane_or`` a tensor on its live accumulator views (counted from 0),
    then as the batched ``plane_or_segments`` launch; byte-equal, both
    timed with the host clock, synchronised. Returns the path's counts,
    the batched operands and result, the per-tensor operands and the
    slots."""
    from repro_torch.core.plane_store import next_plane_shift
    from repro_torch.core.progressive import ReceiverState

    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages):
        state = state.receive(prog.stage(s))
    store = state.store
    last = dict(prog.stage(prog.n_stages))
    per_tensor = [(store._slice_acc(i), last[i], next_plane_shift(t.schedule, 7))
                  for i, t in enumerate(store.slots)]
    acc = store.buffers["uint16"]
    _, plane, shifts = store.round_operands(last)["uint16"]
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    outs = [ops.plane_or(a, p, shift=s) for a, p, s in per_tensor]
    torch.cuda.synchronize()
    t_each = time.perf_counter() - t0
    run_counts, op_counts = counts(), dict(ops.LAUNCH_COUNTS)
    check(run_counts["plane_or"] == op_counts["plane_or"] == len(per_tensor)
          and sum(run_counts.values()) == len(per_tensor), run_counts)
    t0 = time.perf_counter()
    out = ops.plane_or_segments(acc, plane, shifts)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    for t, o in zip(store.slots, outs):
        check(torch.equal(o.reshape(-1), out[t.offset:t.offset + t.size]),
              f"per-tensor upgrade of {t.key} differs from the batched one")
    log(f"[upgrade per tensor] stage 8 as {len(outs)} plane_or launches on the live stage-7 "
        f"views (uint16 acc, uint8 plane): {t_each * 1e3:.3f} ms; one batched "
        f"plane_or_segments launch: {t_batched * 1e3:.3f} ms (host clock, synchronised, "
        f"first calls); byte-equal")
    return run_counts, acc, plane, shifts, out, per_tensor, store.slots


def _pool_phase(model, prog, dev, ops):
    """Serve 12 requests through the slot pool from stage 1, one upgrade
    per window up to stage 8, and check what came out and which kernels
    ran. Returns the drained pool, the run's launch counts and
    ``dequant_matmul``'s launches by route."""
    from repro_torch.serving.engine import PoolRequest, SlotPoolEngine

    cfg = model.cfg
    lengths, budgets, prompts = _pool_requests(cfg)
    checked = FiniteLogits(model)
    pool = SlotPoolEngine(checked, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                          resident="quantized", dispatch_window=POOL_WINDOW,
                          prefill_chunk=POOL_CHUNK, device=dev)
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    pool.receive_stage()
    for rid in range(POOL_REQUESTS):
        pool.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                max_new_tokens=int(budgets[rid])))
    out = pool.run(on_window=lambda _: pool.upgrade_if_available())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts, routes = counts(), route_counts()
    gemv_by = check_one_pass(routes, "pool")
    op_counts = dict(ops.LAUNCH_COUNTS)

    layers, ticks, steps = cfg.n_layers, pool._tick_count, pool._step_count
    report = pool.resident_report()
    check(sorted(out) == list(range(POOL_REQUESTS)), sorted(out))
    for rid, toks in out.items():
        check(len(toks) == budgets[rid], (rid, len(toks), budgets[rid]))
        check(all(0 <= t < cfg.vocab for t in toks), f"request {rid}: token out of vocab")
    check(pool.completed == set(range(POOL_REQUESTS)), pool.completed)
    check(bool(torch.stack(checked.flags).all()), "non-finite pool logits")
    check(report["fp_bytes"] == 0, report["fp_bytes"])
    check(pool.stage == prog.n_stages == 8, f"pool ended at stage {pool.stage}")
    check(run_counts["plane_or_segments"] == 8, run_counts)
    check(ticks > 0 and op_counts["prefill_attention"] == run_counts["flash_verify"]
          == layers * ticks, (op_counts, run_counts, ticks))
    check(run_counts["decode_attention"] == op_counts["decode_attention"]
          == layers * steps, (run_counts, steps))
    check(run_counts["dequant_matmul"] == op_counts["dequant_matmul"]
          == (layers * 7 + 1) * (ticks + steps), (run_counts, ticks, steps))
    check("verify_attention" not in op_counts, op_counts)
    # a chunk tick runs every weight at M = slots x chunk, a decode step at
    # M = slots
    check(routes == expect_routes(pass_calls(layers, ticks, POOL_SLOTS * POOL_CHUNK)
                                  + pass_calls(layers, steps, POOL_SLOTS)), routes)
    n_tok = sum(len(t) for t in out.values())
    ttft = [pool.ttft_s[rid] for rid in range(POOL_REQUESTS)]
    log(f"[pool] {POOL_REQUESTS} requests, prompts {int(lengths.min())}-"
        f"{int(lengths.max())} tokens, budgets {int(budgets.min())}-{int(budgets.max())}; "
        f"{POOL_SLOTS} slots, chunk {POOL_CHUNK}, window {POOL_WINDOW}; stages "
        f"1->{pool.stage}, upgrades at steps {[s for s, _ in pool.upgrades]}")
    log(f"[pool] {steps} decode steps, {ticks} chunk ticks, "
        f"{len(pool.window_stats)} windows; launches in the run {run_counts}; "
        f"dequant_matmul by route {routes}, GEMV route by kernel {gemv_by}; "
        f"every request got its budget of in-vocab tokens, logits finite, fp bytes 0")
    log(f"[pool] {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s; TTFT mean "
        f"{sum(ttft) / len(ttft) * 1e3:.1f} ms, largest {max(ttft) * 1e3:.1f} ms; upgrade "
        f"enqueue ms {[round(u['enqueue_s'] * 1e3, 2) for u in pool.upgrade_log]}")
    return pool, run_counts, routes


def _pool_requests(cfg):
    """The pool paths' requests: prompt lengths, budgets and prompts."""
    rng = np.random.default_rng(3)
    lengths = rng.integers(16, 97, POOL_REQUESTS)
    budgets = rng.integers(24, 41, POOL_REQUESTS)
    return lengths, budgets, [rng.integers(0, cfg.vocab, int(n)) for n in lengths]


def _b2_steps(rounds) -> tuple[int, int]:
    """Decode steps and verify passes of speculation rounds (their accept
    records): a round of k drafts is k decode steps and one verify, a
    k = 0 round one decode step."""
    return (sum(r["k"] if r["k"] else 1 for r in rounds),
            sum(1 for r in rounds if r["k"]))


def _spec_phase(model, prog, dev, ops, prompt, plain_bytes) -> dict:
    """``[spec]``: ``SpeculativeEngine`` on phase 3's planes (in-memory
    receiver). The plain server's tokens at each stage come first; then,
    counted from 0: (a) at each of the 8 stages, a fresh start at batch 4
    and SPEC_TOKENS tokens, k = 4 and adaptive, each ``torch.equal`` to
    ``ProgressiveServer(resident="quantized")`` at the same stage; (b) at
    batch 1, 48 tokens with stages 2-8 landing between rounds,
    ``torch.equal`` to a batch-1 server replayed at the run's per-token
    stage log. Every B2 launch but the prefills' layer weights runs on the
    GEMV route's one-pass kernels, the verify passes included; the draft
    adds no resident bytes. Returns the path's counts, B2's launches by
    route and the stage-8 engine's record."""
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    cfg, layers = model.cfg, model.cfg.n_layers
    plain = ProgressiveServer(model, prog, max_len=PROMPT + SPEC_TOKENS, resident="quantized",
                              device=dev)
    engines = {name: SpeculativeEngine(model, prog, max_len=PROMPT + SPEC_TOKENS + 9,
                                       spec=SpecConfig(draft_bits=4, k=k), device=dev)
               for name, k in (("k4", 4), ("adaptive", None))}
    wants, plain_s = {}, 0.0
    for s in range(1, prog.n_stages + 1):
        plain.receive_stage()
        plain.start({"tokens": prompt})
        pres = plain.decode(SPEC_TOKENS)
        wants[s] = pres.tokens.cpu()
        plain_s += sum(t for _, t in pres.window_s)
    torch.cuda.synchronize()
    reset_counts(ops)
    rounds, starts, by_stage = [], 0, {}
    spec_s = {name: 0.0 for name in engines}
    for s in range(1, prog.n_stages + 1):
        for name, eng in engines.items():
            eng.receive_stage()
            eng.start({"tokens": prompt})
            res = eng.decode(SPEC_TOKENS)
            starts += 1
            check(torch.equal(res.tokens, wants[s]), f"[spec] {name} stage {s}: tokens differ "
                  f"from the plain server's")
            rounds += res.accept_rounds
            spec_s[name] += res.wall_s
            by_stage[(name, s)] = (res.rounds, res.drafted, res.accepted,
                                   eng.current_draft_bits(),
                                   sorted({r["k"] for r in res.accept_rounds}))
    # (b) batch 1, the stages landing between rounds
    eng1 = SpeculativeEngine(model, prog, max_len=PROMPT + 48 + 9,
                             spec=SpecConfig(draft_bits=4, k=4), device=dev)
    eng1.receive_stage()
    eng1.start({"tokens": prompt[:1]})
    starts += 1
    res1 = eng1.decode(48, stage_arrival=lambda done: done >= ARRIVALS[eng1.stage - 1])
    rounds += res1.accept_rounds
    torch.cuda.synchronize()
    run_counts, op_counts, routes = counts(), dict(ops.LAUNCH_COUNTS), route_counts()
    gemv_by = check_one_pass(routes, "spec")
    check(eng1.stage == 8 and [u for _, u in res1.upgrades] == list(range(2, 9)),
          res1.upgrades)
    replay = _stage_replay(model, prog, prompt[:1], res1.stage_log[0], dev)
    check(res1.tokens[0].tolist() == replay, "[spec] batch-1 tokens differ from the "
          "stage-log replay")
    steps, verifies = _b2_steps(rounds)
    want_routes = {"mma": layers * 7 * starts,
                   "gemv": (layers * 7 + 1) * (steps + verifies) + starts}
    check(routes == want_routes, (routes, want_routes))
    check(run_counts["flash_verify"] == op_counts["verify_attention"] == layers * verifies,
          (run_counts, verifies))
    check(run_counts["decode_attention"] == layers * steps, run_counts)
    check(run_counts["plane_or_segments"] == 3 * 8, run_counts)
    want = wants[prog.n_stages]
    # zero extra bytes: the views share every q; no float leaf
    eng = engines["k4"]
    rep = eng.resident_report()
    check(rep["extra_draft_bytes"] == 0 and rep["fp_bytes"] == 0, rep["extra_draft_bytes"])
    check(rep["quantized_bytes"] == plain_bytes, (rep["quantized_bytes"], plain_bytes))
    shared = _shared_q(eng.params, eng.draft_params)
    # the draft is a different model: one decode step of each view from
    # the plain server's stage-8 caches
    tok = want[:, -1:].to(dev)
    lt, _ = model.decode_step(eng.params, _clone(plain.caches), tok, plain.pos)
    ld, _ = model.decode_step(eng.draft_params, _clone(plain.caches), tok, plain.pos)
    gap = float((ld - lt).abs().max()) / float(lt.abs().max())
    check(gap > 0, "the draft view's logits equal the target's")
    distinct = len(set(want.reshape(-1).tolist()))
    log(f"[spec] (a) batch {BATCH}, prompt {PROMPT}, {SPEC_TOKENS} tokens from a fresh start "
        f"at each of the 8 stages, k = 4 and adaptive (draft 4 bits): tokens equal "
        f"(torch.equal) to ProgressiveServer(resident='quantized') at every stage")
    toks = prog.n_stages * BATCH * SPEC_TOKENS
    log(f"[spec] plain ProgressiveServer in the same phase: {toks / plain_s:.1f} tokens/s "
        f"over its 8 runs ({plain_s:.3f} s, windows of 8 steps)")
    for name in engines:
        log(f"[spec] {name}: {toks / spec_s[name]:.1f} tokens/s over the 8 runs "
            f"({spec_s[name]:.3f} s); by stage (rounds, drafted, accepted, draft bits, "
            f"k chosen): " + "; ".join(f"{s} {by_stage[(name, s)]}"
                                       for s in range(1, prog.n_stages + 1)))
    log(f"[spec] (b) batch 1, 48 tokens, stages 2-8 landing between rounds at "
        f"{[u for u in res1.upgrades]}: {res1.rounds} rounds, {res1.accepted}/{res1.drafted} "
        f"drafts accepted, {48 / res1.wall_s:.1f} tokens/s; tokens equal to a batch-1 "
        f"ProgressiveServer replayed at the run's per-token stage log")
    log(f"[spec] launches in the run {run_counts}; dequant_matmul by route {routes} "
        f"(decode steps {steps}, verify passes {verifies} at M = T x slots, "
        f"prefills {starts}): every launch but the prefills' layer weights on the GEMV "
        f"route, GEMV route by kernel {gemv_by}")
    log(f"[spec] the draft (4 bits) against the target (16) at stage 8, one decode step: "
        f"max |logit difference| / max |logit| {gap:.3e}, argmax equal in "
        f"{int((ld.argmax(-1) == lt.argmax(-1)).sum())} of {BATCH} slots; the plain stream "
        f"at stage 8 holds {distinct} distinct tokens of {want.numel()}")
    log(f"[spec] zero extra bytes: draft and target share all {shared} q tensors "
        f"(data_ptr), extra_draft_bytes 0, fp_bytes 0, quantized_bytes "
        f"{rep['quantized_bytes']} = the plain server's")
    return {"counts": run_counts, "routes": routes, "engine": eng, "plain": plain,
            "tok_s": {**{name: toks / spec_s[name] for name in engines},
                      "plain": toks / plain_s}}


def _scaled_model(model, dev):
    """Phase 2's seed-0 weights with every decoder weight scaled by
    DECODER_SCALE, divided on the card. With the weights as initialised
    the residual stream keeps the input token's own embedding on top, so
    the tied unembedding repeats the last token and any draft agrees with
    its target; scaled, the layers pick the next token, the stream varies,
    and the 4-bit draft is rejected in part."""
    from repro_torch.core.progressive import divide

    def scaled(tree):
        if isinstance(tree, dict):
            return {k: scaled(v) for k, v in tree.items()}
        return tree * DECODER_SCALE

    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    params["decoder"] = scaled(params["decoder"])
    return divide(params)


def _spec_rejections(model, prog, prompt, dev) -> dict:
    """``[reject]`` single stream: on the scaled model, draft 4 bits,
    k = 4, batch 4, a fresh start at stages 4-8, each run's tokens
    ``torch.equal`` to the plain server's at that stage; the rounds
    reject drafts, accept part of a slot's and leave the slots ragged, so
    that the partial-accept gather and ragged positions run. Fails unless
    some round accepts part of a slot's drafts."""
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    plain = ProgressiveServer(model, prog, max_len=PROMPT + SPEC_TOKENS, resident="quantized",
                              device=dev)
    eng = SpeculativeEngine(model, prog, max_len=PROMPT + SPEC_TOKENS + 9,
                            spec=SpecConfig(draft_bits=4, k=4), device=dev)
    by_stage, drafted, accepted, partial, distinct = {}, 0, 0, 0, set()
    for s in range(1, prog.n_stages + 1):
        plain.receive_stage()
        eng.receive_stage()
        if s < 4:
            continue
        plain.start({"tokens": prompt})
        want = plain.decode(SPEC_TOKENS).tokens.cpu()
        eng.start({"tokens": prompt})
        res = eng.decode(SPEC_TOKENS)
        check(torch.equal(res.tokens, want), f"[reject] stage {s}: speculative tokens differ "
              f"from the plain server's")
        rnds = [r for r in res.accept_rounds if r["k"]]
        by_stage[s] = (res.drafted, res.accepted,
                       sum(1 for r in rnds if min(r["accepted"]) == 0),
                       sum(1 for r in rnds if any(0 < n < r["k"] for n in r["accepted"])),
                       sum(1 for r in rnds if len(set(r["accepted"])) > 1), len(rnds))
        drafted += res.drafted
        accepted += res.accepted
        partial += by_stage[s][3]
        distinct |= set(want.reshape(-1).tolist())
    check(accepted < drafted and partial > 0, f"[reject] no draft rejected, or none in part "
          f"({accepted}/{drafted}, {partial} partial rounds)")
    log(f"[reject] the decoder's weights x {DECODER_SCALE} (seed 0): plain streams of "
        f"{len(distinct)} distinct tokens over stages 4-8; SpeculativeEngine, draft 4 bits, "
        f"k = 4, batch {BATCH}, {SPEC_TOKENS} tokens from a fresh start at each stage: tokens "
        f"equal (torch.equal) to ProgressiveServer's at every stage; by stage (drafted, "
        f"accepted, rounds with a slot rejecting every draft, with a slot accepting part, "
        f"with ragged slots, rounds): " + "; ".join(f"{s} {r}" for s, r in by_stage.items())
        + f"; acceptance {accepted}/{drafted} = {accepted / drafted:.3f}")
    return {"drafted": drafted, "accepted": accepted, "partial": partial}


def _spec_pool_rejections(model, prog, dev) -> dict:
    """``[reject]`` pool: the scaled model's 8 stages, the pool phase's 12
    requests on ``SpeculativeSlotPool`` (draft 4 bits, k = 3), each
    request's tokens ``torch.equal`` to a plain ``SlotPoolEngine``'s:
    the pool's partial takes and position bounds run. Fails unless some
    draft is rejected."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine, SpecConfig
    from repro_torch.serving import SpeculativeSlotPool

    _, budgets, prompts = _pool_requests(model.cfg)
    out = {}
    for name, eng in (("plain", SlotPoolEngine(model, prog, n_slots=POOL_SLOTS,
                                               max_len=POOL_MAX_LEN, resident="quantized",
                                               dispatch_window=POOL_WINDOW,
                                               prefill_chunk=POOL_CHUNK, device=dev)),
                      ("spec", SpeculativeSlotPool(model, prog, n_slots=POOL_SLOTS,
                                                   max_len=POOL_MAX_LEN,
                                                   spec=SpecConfig(draft_bits=4, k=3),
                                                   dispatch_window=POOL_WINDOW,
                                                   prefill_chunk=POOL_CHUNK,
                                                   device=dev))):
        for _ in range(prog.n_stages):
            eng.receive_stage()
        for rid in range(POOL_REQUESTS):
            eng.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                   max_new_tokens=int(budgets[rid])))
        out[name] = eng.run()
    for rid in range(POOL_REQUESTS):
        check(out["spec"][rid] == out["plain"][rid], f"[reject] pool request {rid}: tokens "
              f"differ from the plain pool's")
    log_ = eng.accept_log
    drafted = sum(r["k"] * len(r["accepted"]) for r in log_)
    accepted = sum(sum(r["accepted"]) for r in log_)
    partial = sum(1 for r in log_ if any(0 < n < r["k"] for n in r["accepted"]))
    check(accepted < drafted, f"[reject] pool: no draft rejected ({accepted}/{drafted})")
    log(f"[reject] SpeculativeSlotPool on the same model, draft 4 bits, k = 3, the pool's "
        f"{POOL_REQUESTS} requests at stage 8: every request's tokens equal (torch.equal) to a "
        f"plain SlotPoolEngine's; acceptance {accepted}/{drafted} = {accepted / drafted:.3f}; "
        f"{partial} of {len(log_)} rounds accept part of a slot's drafts")
    return {"drafted": drafted, "accepted": accepted, "partial": partial}


def _clone(caches):
    return {"cycles": {n: {kv: t.clone() for kv, t in c.items()}
                       for n, c in caches["cycles"].items()}, "tail": {}}


def _shared_q(target, draft) -> int:
    """Check that every quantized leaf of the draft view reads the target
    view's q (the same storage); returns how many."""
    from repro_torch.core.progressive import tree_flatten_with_path
    from repro_torch.core.quantize import QuantizedTensor

    t, d = dict(tree_flatten_with_path(target)), dict(tree_flatten_with_path(draft))
    n = 0
    for path, leaf in t.items():
        if isinstance(leaf, QuantizedTensor):
            check(d[path].q.data_ptr() == leaf.q.data_ptr(), f"draft q of {path} not shared")
            check(d[path].keep_bits is not None and leaf.keep_bits is not None, path)
            n += 1
    check(n > 0, "no quantized leaves")
    return n


def _stage_replay(model, prog, prompt, stage_log, dev) -> list:
    """Plain greedy tokens of a batch-1 ``ProgressiveServer`` replayed at a
    speculative run's per-token stage log: token j's value is computed at
    stage_log[j], its K/V written by the step that computes token j + 1."""
    from repro_torch.serving import ProgressiveServer

    srv = ProgressiveServer(model, prog, max_len=prompt.shape[1] + len(stage_log),
                            resident="quantized", device=dev)
    while srv.stage < stage_log[0]:
        srv.receive_stage()
    srv.start({"tokens": prompt})
    toks = [torch.argmax(srv.last_logits, dim=-1)[:, None]]
    pos = prompt.shape[1]
    for stage in stage_log[1:]:
        while srv.stage < stage:
            srv.receive_stage()
        logits, srv.caches = model.decode_step(srv.params, srv.caches, toks[-1], pos)
        pos += 1
        toks.append(torch.argmax(logits, dim=-1)[:, None])
    return torch.cat(toks, dim=1)[0].tolist()


def _spec_pool_phase(model, prog, dev, ops) -> dict:
    """``[spec pool]``: ``SpeculativeSlotPool`` (8 slots, chunk 8, k = 3)
    on all 8 stages, the pool phase's 12 requests, counted from 0; each
    request's tokens ``torch.equal`` to a plain ``SlotPoolEngine``'s on
    the same requests at stage 8 (both prefill in ticks of M = 64, whose
    rows do not depend on the other rows, and decode on GEMV rows)."""
    from repro_torch.serving import PoolRequest, SlotPoolEngine, SpecConfig
    from repro_torch.serving import SpeculativeSlotPool

    cfg, layers = model.cfg, model.cfg.n_layers
    lengths, budgets, prompts = _pool_requests(cfg)
    spec = SpeculativeSlotPool(model, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                               spec=SpecConfig(draft_bits=4, k=3), dispatch_window=POOL_WINDOW,
                               prefill_chunk=POOL_CHUNK, device=dev)
    plain = SlotPoolEngine(model, prog, n_slots=POOL_SLOTS, max_len=POOL_MAX_LEN,
                           resident="quantized", dispatch_window=POOL_WINDOW,
                           prefill_chunk=POOL_CHUNK, device=dev)
    for p in (plain, spec):
        for _ in range(prog.n_stages):
            p.receive_stage()
    torch.cuda.synchronize()
    reset_counts(ops)
    t0 = time.perf_counter()
    for rid in range(POOL_REQUESTS):
        spec.submit(PoolRequest(rid=rid, prompt=prompts[rid], max_new_tokens=int(budgets[rid])))
    out = spec.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_counts, op_counts, routes = counts(), dict(ops.LAUNCH_COUNTS), route_counts()
    gemv_by = check_one_pass(routes, "spec pool")
    for rid in range(POOL_REQUESTS):
        plain.submit(PoolRequest(rid=rid, prompt=prompts[rid],
                                 max_new_tokens=int(budgets[rid])))
    want = plain.run()
    for rid in range(POOL_REQUESTS):
        check(len(out[rid]) == budgets[rid], (rid, len(out[rid])))
        check(out[rid] == want[rid], f"[spec pool] request {rid}: tokens differ from the "
              f"plain pool's")
    steps, verifies = _b2_steps(spec.accept_log)
    ticks = spec._tick_count
    check(routes == {"mma": (layers * 7 + 1) * ticks,
                     "gemv": (layers * 7 + 1) * (steps + verifies)},
          (routes, ticks, steps, verifies))
    check(run_counts["flash_verify"] == layers * (ticks + verifies)
          and op_counts["verify_attention"] == layers * verifies, (run_counts, op_counts))
    drafted = sum(r["k"] * len(r["accepted"]) for r in spec.accept_log)
    accepted = sum(sum(r["accepted"]) for r in spec.accept_log)
    n_tok = sum(len(t) for t in out.values())
    ttft = [spec.ttft_s[rid] for rid in range(POOL_REQUESTS)]
    log(f"[spec pool] {POOL_REQUESTS} requests (prompts {int(lengths.min())}-"
        f"{int(lengths.max())}, budgets {int(budgets.min())}-{int(budgets.max())}), "
        f"{POOL_SLOTS} slots, chunk {POOL_CHUNK}, k = 3 on all 8 stages: every request's "
        f"tokens equal (torch.equal) to a plain SlotPoolEngine's at stage 8")
    log(f"[spec pool] {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s; TTFT mean "
        f"{sum(ttft) / len(ttft) * 1e3:.1f} ms, largest {max(ttft) * 1e3:.1f} ms; "
        f"{len(spec.accept_log)} rounds, {ticks} chunk ticks; acceptance "
        f"{accepted}/{drafted} = {accepted / max(drafted, 1):.3f}; launches {run_counts}; "
        f"dequant_matmul by route {routes}, GEMV route by kernel {gemv_by}")
    return {"counts": run_counts, "routes": routes, "tok_s": n_tok / wall}


def _verify_patterns(model, params, target, draft, dev, g) -> int:
    """A verify step's logits and the K/V it writes against sequential
    ``decode_step``s of the same blocks, after reject-all, alternate and
    accept-all patterns: rounds of k draft steps (draft view) and one
    T = k + 1 verify (target view) on one set of caches, the same blocks
    decoded token by token on another, ragged across BATCH slots. Returns
    the rounds checked."""
    B, k, n_rounds = BATCH, 4, 3
    prompt = torch.randint(0, model.cfg.vocab, (B, 16), generator=g, device=dev)
    checked = 0
    for pattern in ("reject_all", "alternate", "accept_all"):
        logits, caches = model.prefill(params, {"tokens": prompt})
        spec_c = model.grow_caches(caches, 16 + n_rounds * (k + 1) + 1)
        seq_c = _clone(spec_c)
        last = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        pos = torch.full((B,), 16, dtype=torch.int32, device=dev)
        for rnd in range(n_rounds):
            toks, cur = [last], last
            for j in range(k):
                lg, spec_c = model.decode_step(draft, spec_c, cur, pos + j)
                cur = torch.argmax(lg, dim=-1).to(torch.int32)[:, None]
                toks.append(cur)
            block = torch.cat(toks, dim=1)
            vlog, spec_c = model.verify_step(target, spec_c, block, pos)
            for t in range(k + 1):
                lg, seq_c = model.decode_step(params, seq_c, block[:, t:t + 1], pos + t)
                check(torch.equal(vlog[:, t], lg), f"verify row {t} of round {rnd} "
                      f"({pattern}) differs from its decode step")
            for n, c in spec_c["cycles"].items():
                for kv in ("k", "v"):
                    check(torch.equal(c[kv], seq_c["cycles"][n][kv]),
                          f"{pattern} round {rnd}: cache {kv} differs")
            acc = {"reject_all": [0] * B, "accept_all": [k] * B,
                   "alternate": [k if (rnd + b) % 2 else 0 for b in range(B)]}[pattern]
            acc_t = torch.tensor(acc, device=dev)
            last = torch.gather(torch.argmax(vlog, dim=-1).to(torch.int32), 1, acc_t[:, None])
            pos = pos + acc_t.to(torch.int32) + 1
            checked += 1
    return checked


def _verify_timings(model, eng, dev, g) -> dict:
    """``[time]`` one verify step by CUDA-graph replay at M = 20 (batch 4,
    T = 5) and M = 32 (8 slots, T = 4): its dense layers on the GEMV route
    (rows="decode", as ``verify_step`` runs them) and on the tensor-core
    route (the route M picks), the cost of the choice; host issue ms of the
    step and of a whole round (k = 4 draft steps and the verify)."""
    from repro_torch.kernels import ops

    out = {}
    dqmm = ops.dequant_matmul
    for B, T in ((BATCH, 5), (POOL_SLOTS, 4)):
        caches = model.init_caches(B, POOL_MAX_LEN, device=dev)
        toks = torch.randint(0, model.cfg.vocab, (B, T), generator=g, device=dev,
                             dtype=torch.int32)
        pos = torch.full((B,), PROMPT, dtype=torch.int32, device=dev)

        def step():
            model.verify_step(eng.params, caches, toks, pos)

        gemv_ms = device_ms(step, 2)
        # the route M picks, for the timing: every launch with rows="any"
        ops.dequant_matmul = lambda *a, rows, **kw: dqmm(*a, **kw)
        try:
            mma_ms = device_ms(step, 2)
        finally:
            ops.dequant_matmul = dqmm
        gemv_ms2 = device_ms(step, 2)
        row = {"M": B * T, "gemv_ms": [gemv_ms, gemv_ms2], "mma_ms": mma_ms,
               "host_ms": host_ms(step, 3)}
        if B == BATCH:
            last = toks[:, :1].contiguous()
            rnd = lambda: eng._run_round(caches, last, pos, 4)   # noqa: E731
            row["round_device_ms"] = device_ms(rnd, 1)
            row["round_host_ms"] = host_ms(rnd, 3)
        out[f"M={B * T}"] = row
        log(f"[time] verify_step B={B} T={T} (M={B * T}), stage 8, one step by graph replay: "
            f"GEMV route (rows='decode') {gemv_ms:.4f}, {gemv_ms2:.4f} ms; tensor-core route "
            f"{mma_ms:.4f} ms; cost of the GEMV route {min(gemv_ms, gemv_ms2) - mma_ms:+.4f} ms; "
            f"host issue {row['host_ms']:.3f} ms"
            + (f"; a round (k = 4 drafts + verify): device {row['round_device_ms']:.4f} ms, "
               f"host issue {row['round_host_ms']:.3f} ms" if B == BATCH else ""))
        del caches
    return out


def _dqmm_bound(calls) -> tuple[float, str]:
    """The least time for ``dequant_matmul`` over ``calls`` ((x, weight)
    pairs), whichever route runs it: each x, q and output crossing device
    memory once, or the function's 2MKN products once at the bf16
    tensor-core peak (its products are exact in bf16 once q and x are
    split), whichever is larger. The splits' extra passes are the
    kernel's cost, not the function's."""
    n_b, n_ops = 0, 0
    for x, w in calls:
        M, (K, N) = x.shape[0], w.q.shape
        n_b += w.q.numel() * w.q.element_size() + x.numel() * x.element_size() + M * N * 4
        n_ops += 2 * M * K * N
    t_bytes, t_ops = n_b / HBM_BYTES_PER_S * 1e3, n_ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _layer_weights(lr: dict) -> list:
    """One layer's seven matmul weights in the order decode runs them."""
    a, m = lr["attn"], lr["mlp"]
    return [a["wq"], a["wk"], a["wv"], a["wo"], m["wi_gate"], m["wi_up"], m["wo"]]


def _whole_path(cfg, dev) -> tuple[float, float]:
    """The same 2-layer full-width weights served on the card and on the
    CPU; teacher-forced logits compared after every stage, and the logits
    of a ragged prefill chunk and a verify block into pooled caches at
    stages 1 and 8. Returns the worst max |err| / max |logit| of each."""
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import ProgressiveServer

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    model = build_model(cfg2)
    params = model.init(torch.Generator(device=dev).manual_seed(3), device=dev)
    params_cpu = {k: v for k, v in _to_cpu(params).items()}
    gpu = ProgressiveServer(model, divide(params), max_len=16 + 2, resident="quantized",
                            device=dev)
    cpu = ProgressiveServer(model, divide(params_cpu), max_len=16 + 2,
                            resident="quantized", device="cpu")
    del params, params_cpu
    g = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg2.vocab, (2, 16), generator=g)
    forced = torch.randint(0, cfg2.vocab, (2, 2), generator=g)
    worst = worst_chunk = 0.0
    for s in range(1, gpu.prog.n_stages + 1):
        gpu.receive_stage()
        cpu.receive_stage()
        check(gpu.state.store.fingerprint() == cpu.state.store.fingerprint(),
              f"accumulators differ at stage {s}")
        gpu.start({"tokens": prompt})
        cpu.start({"tokens": prompt})
        pairs = [(gpu.last_logits, cpu.last_logits)]
        for t in range(forced.shape[1]):
            tok = forced[:, t:t + 1]
            lg, gpu.caches = model.decode_step(gpu.params, gpu.caches, tok.to(dev),
                                               gpu.pos + t)
            lc, cpu.caches = model.decode_step(cpu.params, cpu.caches, tok, cpu.pos + t)
            pairs.append((lg, lc))
        for lg, lc in pairs:
            check(bool(torch.isfinite(lg).all()))
            err = float((lg.cpu() - lc).abs().max()) / float(lc.abs().max())
            check(err <= PATH_RTOL, f"stage {s}: relative logit error {err:.3e}")
            worst = max(worst, err)
        if s in (1, gpu.prog.n_stages):
            worst_chunk = max(worst_chunk, _chunk_and_verify(model, gpu, cpu, g, dev, s))
    return worst, worst_chunk


def _chunk_and_verify(model, gpu, cpu, g, dev, stage) -> float:
    """A prefill chunk (slot 0 at positions 0-7, slot 1 a short chunk of 5
    rows) then a 3-row verify block into pooled caches, on both servers'
    parameters; returns the worst relative logit error."""
    vocab = model.cfg.vocab
    tok_pos = torch.tensor([list(range(8)), [0, 1, 2, 3, 4, -1, -1, -1]],
                           dtype=torch.int32)
    calls = [("prefill_chunk", torch.randint(0, vocab, (2, 8), generator=g), tok_pos),
             ("verify_step", torch.randint(0, vocab, (2, 3), generator=g),
              torch.tensor([8, 5], dtype=torch.int32))]
    caches = {"gpu": model.init_caches(2, 18, device=dev),
              "cpu": model.init_caches(2, 18, device="cpu")}
    worst = 0.0
    for name, toks, pos in calls:
        lg, caches["gpu"] = getattr(model, name)(gpu.params, caches["gpu"], toks.to(dev),
                                                 pos.to(dev))
        lc, caches["cpu"] = getattr(model, name)(cpu.params, caches["cpu"], toks, pos)
        check(bool(torch.isfinite(lg).all()), f"{name}: non-finite logits")
        err = float((lg.cpu() - lc).abs().max()) / float(lc.abs().max())
        check(err <= PATH_RTOL, f"stage {stage} {name}: relative logit error {err:.3e}")
        worst = max(worst, err)
    return worst


def _attention_long(cfg, dev, g, S, da, va, ref) -> dict:
    """``[check]`` and ``[time]`` both attention kernels on one synthetic
    layer of S keys, every key live, at the paths' heads: decode at the
    single stream's batch, verify at the pool's slots and chunk (each row
    also ``torch.equal`` to a decode launch). Device ms a launch beside
    ``scaled_dot_product_attention`` and the bytes bound."""
    H, Kh, hd = cfg.n_heads, cfg.n_kv, cfg.hd
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = {}
    for name, B, T in (("decode_attention", BATCH, 1), ("flash_verify", POOL_SLOTS, POOL_CHUNK)):
        k = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(cfg.dtype)
        v = torch.randn((B, Kh, S, hd), generator=g, device=dev).to(cfg.dtype)
        q = torch.randn((B, T, H, hd), generator=g, device=dev).to(cfg.dtype)
        k_pos = torch.arange(S, dtype=torch.int32, device=dev).repeat(B, 1)
        q_pos = (torch.arange(T, dtype=torch.int32, device=dev) + S - T).repeat(B, 1)
        if T == 1:
            q1, qp1 = q[:, 0].contiguous(), q_pos[:, 0].contiguous()
            fn = lambda: da.flash_decode(q1, k, v, k_pos, qp1)             # noqa: E731
            want = ref.flash_decode_ref(q1, k, v, k_pos, qp1)[:, None]
        else:
            fn = lambda: va.flash_verify(q, k, v, k_pos, q_pos)            # noqa: E731
            want = ref.flash_verify_ref(q, k, v, k_pos, q_pos)
        out = fn().reshape(want.shape)
        check(bool(torch.isfinite(out).all()), f"{name} S={S}: non-finite output")
        err = float((out.float() - want).abs().max())
        check(err <= ATTN_RTOL * float(want.abs().max()), f"{name} S={S}: {err}")
        if T > 1:
            for t in range(T):
                row = da.flash_decode(q[:, t].contiguous(), k, v, k_pos,
                                      q_pos[:, t].contiguous())
                check(torch.equal(out[:, t], row), f"flash_verify S={S} row {t} differs")
        valid = k_pos[:, None, :] <= q_pos[:, :, None]
        mask = torch.where(valid, 0.0, -1e30).to(cfg.dtype)[:, None]    # (B, 1, T, S)
        qh = q.transpose(1, 2)                                          # (B, H, T, hd)
        n_b = 2 * k.numel() * k.element_size() + 2 * q.numel() * q.element_size() \
            + k_pos.numel() * 4 + q_pos.numel() * 4
        b, by = bound_ms(n_b, 4 * B * T * H * S * hd, FP32_FLOPS)
        row = {"ms": device_ms(fn, 10),
               "library_ms": device_ms(lambda: sdpa(qh, k, v, attn_mask=mask,
                                                  enable_gqa=Kh != H), 10),
               "bound_ms": b, "bound_by": by, "max_abs_err": err}
        rows[name] = row
        log(f"[check] {name} S={S} B={B} T={T} H={H} hd={hd} (one synthetic layer, all "
            f"keys live): max |err| {err:.3e}"
            + (f"; each of the {T} rows equal (torch.equal) to a flash_decode launch"
               if T > 1 else ""))
        log(f"[time] {name} S={S} B={B} T={T} H={H} hd={hd}, one launch: kernel "
            f"{row['ms']:.4f} ms on the device, sdpa {row['library_ms']:.4f} ms, bound "
            f"{b:.4f} ms ({by})")
        del k, v
    return rows


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


if __name__ == "__main__":
    sys.exit(main())
