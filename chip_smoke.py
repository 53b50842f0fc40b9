#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and hold every
CUDA kernel of that path against its plain PyTorch version.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. serve full-width olmo-1b from its plane accumulators: ``divide`` with
   the paper's schedule, ``ProgressiveServer(resident="quantized")``,
   one stage, a (4, 64) prompt, 48 decode steps with the other 7 stages
   landing mid-decode; counts every kernel launch of that run;
3. hold each kernel against its plain version on the path's operands;
4. run the same 2-layer full-width model on the card (kernels) and on
   the CPU (plain versions) and compare teacher-forced logits at every
   stage;
5. time each kernel at the path's shapes beside its bound, its plain
   version and one PyTorch call that computes the same function.

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

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # float32 outside the tensor cores

DEVICE = "cuda"
BATCH, PROMPT, STEPS = 4, 64, 48
ARRIVALS = (6, 12, 18, 24, 30, 36, 42)

# Stated tolerances, each with its reason.
# dequant_matmul: the kernel and the plain version form every weight
# with the same two rounded float32 operations and differ only in the
# order of the float32 sum over K (<= 8192 terms): error far below
# 1e-4 of the output's largest magnitude.
DQMM_RTOL = 1e-4
# decode_attention: the kernel writes bfloat16, the plain version
# float32; one bfloat16 rounding is 2**-9 relative, allow 2**-7 of the
# largest output magnitude.
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


def reset_counts(bitplane, dqm, da, ops) -> None:
    bitplane.launches = dqm.launches = da.launches = 0
    ops.reset_launch_counts()


def counts(bitplane, dqm, da) -> dict:
    return {"plane_or_segments": bitplane.launches, "dequant_matmul": dqm.launches,
            "decode_attention": da.launches}


class FiniteLogits:
    """Wraps a Model: records, without a host sync, whether every decode
    step's logits were finite."""

    def __init__(self, model):
        self.model = model
        self.flags: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, params, caches, tokens, pos):
        logits, caches = self.model.decode_step(params, caches, tokens, pos)
        self.flags.append(torch.isfinite(logits).all())
        return logits, caches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import ReceiverState, divide
    from repro_torch.kernels import bitplane, build, ops, ref
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import dequant_matmul as dqm
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import layer
    from repro_torch.serving.engine import ProgressiveServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    t_script = time.perf_counter()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    log(f"[build] 3 kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    print(gpu_line(), flush=True)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # -- 2. full-width serve -------------------------------------------------
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    prog = divide(params)
    del params
    torch.cuda.synchronize()
    log(f"[serve] olmo-1b full width: {n_params} parameters, {prog.n_stages} stages, "
        f"{len(prog.tensors)} tensors; init + divide {time.perf_counter() - t0:.1f} s")
    prompt = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                           generator=torch.Generator().manual_seed(1))
    checked = FiniteLogits(model)
    srv = ProgressiveServer(checked, prog, max_len=PROMPT + STEPS, resident="quantized",
                            device=dev)
    torch.cuda.synchronize()
    reset_counts(bitplane, dqm, da, ops)
    t0 = time.perf_counter()
    srv.receive_stage()
    srv.start({"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = counts(bitplane, dqm, da)
    res = srv.decode(STEPS, stage_arrival=lambda i: i in ARRIVALS)
    torch.cuda.synchronize()
    path_counts = counts(bitplane, dqm, da)
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
    tok_s = BATCH * STEPS / decode_s
    log(f"[serve] stages {res.stage_at_step[0]}->{res.stage_at_step[-1]}, upgrades "
        f"{res.upgrades}; logits finite; resident {report['quantized_bytes']} B "
        f"quantized, {report['fp_bytes']} B fp")
    log(f"[serve] launches in the run {path_counts}; per decode step "
        f"dequant_matmul {per_step['dequant_matmul']:.0f}, decode_attention "
        f"{per_step['decode_attention']:.0f}")
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

    # -- 3. each kernel against its plain version on the path's operands ----
    kern: dict[str, dict] = {}
    # plane_or_segments: the accumulators after stage 7 and stage 8's plane
    state = ReceiverState.init(prog, device=dev)
    for s in range(1, prog.n_stages):
        state = state.receive(prog.stage(s))
    acc = state.store.buffers["uint16"]
    _, plane, shifts = state.store.round_operands(dict(prog.stage(prog.n_stages)))["uint16"]
    del state
    out = bitplane.plane_or_segments(acc, plane, shifts)
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
    del out

    # dequant_matmul: every distinct (M, K, N) of the path, on the live
    # accumulators of layer 0 at stage 8
    P = srv.params
    l0 = layer(P["decoder"]["cycles"]["0_attn"], 0)
    weights = {"attn.wq": l0["attn"]["wq"], "mlp.wi_gate": l0["mlp"]["wi_gate"],
               "mlp.wo": l0["mlp"]["wo"], "embed.T": P["embed"].T}
    # (name, M): decode runs every weight at M = BATCH, prefill the layer
    # weights at M = BATCH * PROMPT and the unembedding at M = BATCH
    shapes = [(w, BATCH) for w in weights] + \
             [(w, BATCH * PROMPT) for w in ("attn.wq", "mlp.wi_gate", "mlp.wo")]
    xg = torch.Generator(device=dev).manual_seed(2)
    dq_err = 0.0
    for name, M in shapes:
        w = weights[name]
        K = w.q.shape[0]
        x = torch.randn((M, K), generator=xg, device=dev).to(cfg.dtype)
        y = dqm.dequant_matmul(x, w.q, w.scale, w.offset)
        yr = ref.dequant_matmul_ref(x, w.q, w.scale, w.offset)
        err = float((y - yr).abs().max())
        mag = float(yr.abs().max())
        check(err <= DQMM_RTOL * mag, (name, M, err, mag))
        dq_err = max(dq_err, err)
        log(f"[check] dequant_matmul {name} M={M} K={K} N={w.q.shape[1]} "
            f"q strides {tuple(w.q.stride())}: max |err| {err:.3e} (max |y| {mag:.3e})")
    kern["dequant_matmul"] = {"max_abs_err": dq_err}

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

    # -- 4. whole path: 2 layers at full width, card against CPU -------------
    t0 = time.perf_counter()
    path_err = _whole_path(cfg, dev)
    log(f"[path] 2-layer full width, cuda kernels vs cpu plain versions, teacher-forced "
        f"logits at all 8 stages: max |err| / max |logit| = {path_err:.3e} "
        f"(tolerance {PATH_RTOL}); {time.perf_counter() - t0:.1f} s")

    # -- 5. timings at the path's shapes -------------------------------------
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

    # dequant_matmul: the decode step's 113 launches, in its order
    stack = P["decoder"]["cycles"]["0_attn"]
    xs = {k: torch.randn((BATCH, k), generator=xg, device=dev).to(cfg.dtype)
          for k in (cfg.d_model, cfg.d_ff)}
    calls = [(xs[w.q.shape[0]], w) for r in range(layers)
             for w in _layer_weights(layer(stack, r))] + [(xs[cfg.d_model], P["embed"].T)]
    check(len(calls) == per_step["dequant_matmul"], len(calls))

    def run(fn, subset=calls):
        for x, w in subset:
            fn(x, w.q, w.scale, w.offset)

    for shape in sorted({tuple(w.q.shape) for _, w in calls}):
        sub = [(x, w) for x, w in calls if tuple(w.q.shape) == shape]
        K, N = shape
        n_b = len(sub) * (K * N * 2 + BATCH * K * 2 + BATCH * N * 4)
        b, by = bound_ms(n_b, len(sub) * 2 * BATCH * K * N, FP32_FLOPS)
        log(f"[time] dequant_matmul M={BATCH} K={K} N={N} x{len(sub)} per step: kernel "
            f"{device_ms(lambda: run(dqm.dequant_matmul, sub), 3) * 1e3:.1f} us, "
            f"bound {b * 1e3:.1f} us ({by})")
    n_b = sum(w.q.numel() * w.q.element_size() + x.numel() * x.element_size()
              + BATCH * w.q.shape[1] * 4 for x, w in calls)
    n_ops = sum(2 * BATCH * w.q.numel() for _, w in calls)
    b, by = bound_ms(n_b, n_ops, FP32_FLOPS)
    step = {"ms": device_ms(lambda: run(dqm.dequant_matmul), 3),
            "plain_ms": device_ms(lambda: run(ref.dequant_matmul_ref), 1),
            "host_ms": host_ms(lambda: run(dqm.dequant_matmul), 3)}
    dense_w = [(x.float(), w.q.to(torch.float32) * w.scale.reshape(()) + w.offset.reshape(()))
               for x, w in calls]
    step["library_ms"] = device_ms(lambda: [torch.matmul(x, w) for x, w in dense_w], 3)
    del dense_w
    kern["dequant_matmul"].update(step, bound_ms=b, bound_by=by,
                                  per=f"one decode step ({len(calls)} launches)")

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

    sources = {"plane_or_segments": ("plane_or.cu", "src/repro/kernels/bitplane.py:89"),
               "dequant_matmul": ("dequant_matmul.cu",
                                  "src/repro/kernels/dequant_matmul.py:70"),
               "decode_attention": ("decode_attention.cu",
                                    "src/repro/kernels/decode_attention.py:101")}
    line = []
    for name, (src, replaces) in sources.items():
        k = kern[name]
        log(f"[time] {name} per {k['per']}: kernel {k['ms']:.4f} ms on the device, "
            f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), plain {k['plain_ms']:.4f} ms, "
            f"library {k['library_ms']:.4f} ms; host issue {k['host_ms']:.4f} ms; "
            f"launches in the run {path_counts[name]}")
        line.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}", "replaces": replaces,
                     "launches": path_counts[name], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    log(f"[done] {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def _layer_weights(lr: dict) -> list:
    """One layer's seven matmul weights in the order decode runs them."""
    a, m = lr["attn"], lr["mlp"]
    return [a["wq"], a["wk"], a["wv"], a["wo"], m["wi_gate"], m["wi_up"], m["wo"]]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _whole_path(cfg, dev) -> float:
    """The same 2-layer full-width weights served on the card and on the
    CPU; teacher-forced logits compared after every stage. Returns the
    worst max |err| / max |logit|."""
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
    worst = 0.0
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
    return worst


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


if __name__ == "__main__":
    sys.exit(main())
