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
4. ``[wire]``: the same model from wire bytes: ``wire.encode`` (v3),
   ``ProgressiveClient.feed`` in seeded ragged chunks of 1 B to 64 MB,
   one stage at each arrival of phase 3's schedule, and
   ``ProgressiveServer(receiver=WireStoreReceiver(...))``: the store's
   fingerprint equals the in-memory receiver's after every stage and the
   tokens equal phase 3's; a unit of stage 3 damaged on a second feed is
   quarantined and repaired to the clean fingerprint; raw v1 streams the
   2-layer full-width model the same way;
5. ``[upgrade per tensor]``: stage 8 as one ``plane_or`` a tensor on the
   live stage-7 accumulator views, byte-equal to the batched
   ``plane_or_segments`` upgrade, both timed;
6. hold each kernel against its plain version on the paths' operands
   (``dequant_matmul`` on both routes, GEMV and tensor-core, at M = 4, 8,
   64 and 256, with activations of zero and of large positive mean), and
   every ``flash_verify`` row against a ``flash_decode`` launch;
7. run the same 2-layer full-width model on the card (kernels) and on
   the CPU (plain versions) and compare teacher-forced decode, prefill
   chunk and verify logits;
8. time each kernel at the paths' shapes beside its bound, its plain
   version and one PyTorch call (or chain of calls) that computes the
   same function: ``dequant_matmul`` over a decode step's, a chunk
   tick's and the prefill's operands, and both of its routes at M = 1 to
   256; one chunk tick of the pool and the single stream's prefill.

``dequant_matmul``'s launches are also counted by route on every path:
the prefill and the chunk ticks run the tensor-core kernel, decode the
GEMV kernel.

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
DQMM_TIME_M = (1, 2, 4, 8, 16, 32, 64, 256)
# wire chunks: log-uniform from 1 byte to 64 MB (numpy seed 5)
CHUNK_MAX = 64 << 20

# Stated tolerances, each with its reason.
# dequant_matmul: the GEMV kernel and the plain version form every weight
# with the same two rounded float32 operations and differ only in the
# order of the float32 sum over K (<= 8192 terms); the tensor-core
# kernel's products are exact and only its float32 sums round (q
# centred, so its two epilogue terms do not cancel): error far below
# 1e-4 of the output's largest magnitude on both routes.
DQMM_RTOL = 1e-4
# decode_attention and flash_verify: the kernels write bfloat16, the
# plain versions float32; one bfloat16 rounding is 2**-9 relative, allow
# 2**-7 of the largest output magnitude.
ATTN_RTOL = 2.0 ** -7
# whole path: bfloat16 activations rounded at other places by the two
# sums orders compound over 2 layers; allow 3% of the largest logit.
PATH_RTOL = 3e-2


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
    by_route = dequant_matmul.launches_by_route
    by_route.update(dict.fromkeys(by_route, 0))
    ops.reset_launch_counts()


def route_counts() -> dict:
    """``dequant_matmul``'s CUDA launches by route since the last reset."""
    from repro_torch.kernels import dequant_matmul

    return dict(dequant_matmul.launches_by_route)


def expect_routes(calls) -> dict:
    """Launches by route for ``calls``: (launches, M, K-contiguous)
    triples, all on uint16 accumulators."""
    from repro_torch.kernels import dequant_matmul

    want = dict.fromkeys(dequant_matmul.launches_by_route, 0)
    for n, M, k_contiguous in calls:
        want[dequant_matmul.route(M, torch.uint16, k_contiguous)] += n
    return want


def pass_calls(layers: int, passes: int, M: int) -> list:
    """``passes`` forward passes at M rows: 7 launches a layer on the (K, N)
    layer weights and the unembedding on the K-contiguous ``embed.T``."""
    return [(passes * layers * 7, M, False), (passes, M, True)]


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
    prefill_calls = [(layers * 7, BATCH * PROMPT, False), (1, BATCH, True)]
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
        f"{prefill_routes}, whole run {serve_routes}")
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

    # -- 4. the same model from wire bytes -----------------------------------
    wire_counts, wire_routes = _wire_phase(model, prog, dev, ops, prompt, res, clean_fps,
                                           serve_routes)
    _wire_v1_check(cfg, dev)

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
    # each route's entry in the kernels line carries its own largest error
    kern["dequant_matmul"] = {"max_abs_err": route_err["gemv"]}

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
        log(f"[time] dequant_matmul M={M} (routes: layer weights to "
            f"{dqm.route(M, torch.uint16)}, embed.T to {dqm.route(M, torch.uint16, True)}): "
            + "; ".join(f"{g} " + ", ".join(f"{k} {t:.4f} ms" for k, t in r.items())
                        for g, r in by_m[M].items()))
    kern["dequant_matmul"]["by_M"] = by_m
    del dense, calls

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
             "wire": wire_counts, "upgrade per tensor": upgrade_counts}
    launches = {name: sum(c.get(name, 0) for c in paths.values()) for name in sources}
    check(all(launches[name] > 0 for name in sources), launches)
    # dequant_matmul's launches by route on the paths that run it
    route_paths = {"serve": serve_routes, "pool": pool_routes, "wire": wire_routes}
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
            entry.update({key: dq[key] for key in ("launches_by_route", "tick", "prefill")})
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
        f"by route {routes}; health "
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
    rng = np.random.default_rng(3)
    lengths = rng.integers(16, 97, POOL_REQUESTS)
    budgets = rng.integers(24, 41, POOL_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)) for n in lengths]
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
        f"dequant_matmul by route {routes}; "
        f"every request got its budget of in-vocab tokens, logits finite, fp bytes 0")
    log(f"[pool] {n_tok} tokens in {wall:.3f} s: {n_tok / wall:.1f} tokens/s; TTFT mean "
        f"{sum(ttft) / len(ttft) * 1e3:.1f} ms, largest {max(ttft) * 1e3:.1f} ms; upgrade "
        f"enqueue ms {[round(u['enqueue_s'] * 1e3, 2) for u in pool.upgrade_log]}")
    return pool, run_counts, routes


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


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


if __name__ == "__main__":
    sys.exit(main())
