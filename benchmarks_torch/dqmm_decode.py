#!/usr/bin/env python3
"""Time ``dequant_matmul`` over one decode step of full-width olmo-1b on
one NVIDIA GPU, from the checkout at ``--root`` (default: this one).

    python3 benchmarks_torch/dqmm_decode.py [--root DIR] [--m 1 4 8] [--out FILE]

A decode step runs 113 launches: 7 a layer on the 16 layers' stacked
uint16 weights (bfloat16 x) and the unembedding on ``embed.T``, the
transposed view of the (50304, 2048) table (float32 x), as the model
calls them. The weights are seeded random uint16 accumulators with a
stage-8 affine. For each M it prints, on a line of its own, the device ms
of the step through the wrapper's routes (one CUDA graph of the 113
launches, replayed between two CUDA events), the host ms to issue it,
the device ms of the 112 layer launches and of ``embed.T`` on each route,
the device us a launch of each weight shape (its 16 launches, or the one
of ``embed.T``, through the wrapper) beside that launch's bytes bound, and
the bytes bound of the step (each q, x and output crossing device memory
once at 3.35 TB/s). It also prints the device us of one launch of a
1-element PyTorch kernel in the same kind of graph: the floor a launch
costs there. The API it calls (``dequant_matmul``, ``_launch_gemv``,
``_launch_mma``, ``route``) is the same in every tree since the
tensor-core route came in, so two trees are compared by running this
script once against each, in turns, in one machine session. Needs a CUDA
device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12
LAYERS, D, F, VOCAB = 16, 2048, 8192, 50304   # olmo-1b (configs/olmo_1b.py)
SHAPES = [(D, D)] * 4 + [(D, F)] * 2 + [(F, D)]   # wq wk wv wo wi_gate wi_up wo


def device_ms(fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e3


def ran_on(call, dqm) -> str:
    """The route the wrapper took for one launch, read from its counters
    (the same in every tree, whatever its routing rule's signature)."""
    x, q = call
    one = q.new_ones((1, 1), dtype=torch.float32)
    before = dict(dqm.launches_by_route)
    dqm.dequant_matmul(x, q, one, one)
    return next(k for k, n in dqm.launches_by_route.items() if n != before[k])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--m", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    if not torch.cuda.is_available():
        print("dqmm_decode: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import dequant_matmul as dqm

    t0 = time.perf_counter()
    for name in ("dequant_matmul", "dequant_matmul_mma"):
        build.library(name)
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    stacks = [torch.randint(0, 65536, (LAYERS, K, N), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint16) for K, N in SHAPES]
    table = torch.randint(0, 65536, (VOCAB, D), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint16)
    scale = torch.full((1, 1), 0.04 / 65536, device=dev)
    offset = torch.full((1, 1), -0.02 + 0.02 / 65536, device=dev)
    layer_qs = [s[r] for r in range(LAYERS) for s in stacks]
    emb = table.T
    one = torch.zeros(1, device=dev)
    floor_us = device_ms(lambda: [one.add_(1) for _ in range(LAYERS)], args.reps) / LAYERS * 1e3
    print(json.dumps({"launch_floor_us": floor_us}), flush=True)
    rows = []
    for M in args.m:
        xs = {k: torch.randn((M, k), generator=g, device=dev).to(torch.bfloat16) for k in (D, F)}
        x_emb = torch.randn((M, D), generator=g, device=dev)
        calls = [(xs[q.shape[0]], q) for q in layer_qs] + [(x_emb, emb)]

        def run(sub, fn=dqm.dequant_matmul):
            for x, q in sub:
                fn(x, q, scale, offset)

        n_b = sum(q.numel() * 2 + x.numel() * x.element_size() + M * q.shape[1] * 4
                  for x, q in calls)
        routes = {"gemv": dqm._launch_gemv, "mma": dqm._launch_mma}
        row = {"M": M, "launches": len(calls),
               "step_ms": device_ms(lambda: run(calls), args.reps),
               "host_ms": host_ms(lambda: run(calls), args.reps),
               "layers_ms": {k: device_ms(lambda: run(calls[:-1], fn), args.reps)
                             for k, fn in routes.items()},
               "embed_T_ms": {k: device_ms(lambda: run(calls[-1:], fn), args.reps)
                              for k, fn in routes.items()},
               "routes": {"layers": ran_on(calls[0], dqm), "embed_T": ran_on(calls[-1], dqm)},
               "bound_ms": n_b / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
               "by_shape": {}}
        for shape in sorted({tuple(q.shape) for _, q in calls}):
            sub = [(x, q) for x, q in calls if tuple(q.shape) == shape]
            x, q = sub[0]
            b = q.numel() * 2 + x.numel() * x.element_size() + M * q.shape[1] * 4
            row["by_shape"]["x".join(map(str, shape))] = {
                "launches": len(sub), "us": device_ms(lambda: run(sub), args.reps) / len(sub) * 1e3,
                "bound_us": b / HBM_BYTES_PER_S * 1e6}
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {"root": os.path.abspath(args.root), "card": card, "build_s": build_s,
              "launch_floor_us": floor_us, "rows": rows}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
