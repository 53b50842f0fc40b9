#!/usr/bin/env python3
"""Time plain greedy decoding of full-width olmo-1b, and the norms it runs,
on one NVIDIA GPU, from the checkout at ``--root`` (default: this one).

    python3 benchmarks_torch/plain_decode.py [--root DIR] [--batch 1 4] [--steps 32]
                                              [--out FILE]

The model is full-width olmo-1b (16 layers, d_model 2048) with seeded
random weights, divided into 8 stages of 2-bit planes and served by
``ProgressiveServer(resident="quantized")`` after all 8 stages, from a
64-token prompt. For each batch it prints, on a line of its own:

* ``tok_s`` and ``step_ms``: ``decode(steps)`` after 8 warm-up steps, by
  the host's clock, synchronised at the end (the eager path as a user
  runs it; host-bound);
* ``step_device_ms`` and ``step_host_ms``: one ``decode_step`` by CUDA-
  graph replay between two CUDA events, and the host time to issue it;
* ``norms_device_ms`` and ``norms_host_ms``: the step's 33 ``apply_norm``
  calls on (batch, 1, 2048) bfloat16 rows, the same two ways.

The API it calls (``build_model``, ``divide``, ``ProgressiveServer``,
``decode_step``, ``apply_norm``) is the same in every tree since the
quantized server came in, so two trees are compared by running this
script against each, in turns, on one machine.
Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

PROMPT, WARMUP, NORMS = 64, 8, 33      # a decode step: 2 norms a layer and the final


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    if not torch.cuda.is_available():
        print("plain_decode: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.kernels import build
    from repro_torch.models import common
    from repro_torch.models.model import build_model
    from repro_torch.serving import ProgressiveServer

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    build_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev))
    g = torch.Generator().manual_seed(args.seed + 1)
    rows = []
    for B in args.batch:
        srv = ProgressiveServer(model, prog, max_len=PROMPT + WARMUP + args.steps + 1,
                                resident="quantized", device=dev)
        for _ in range(prog.n_stages):
            srv.receive_stage()
        srv.start({"tokens": torch.randint(0, cfg.vocab, (B, PROMPT), generator=g)})
        srv.decode(WARMUP)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = srv.decode(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check = res.tokens.shape == (B, args.steps)
        tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        caches, pos = srv.caches, srv.pos

        def step():
            model.decode_step(srv.params, caches, tok, pos)

        h = torch.randn((B, 1, cfg.d_model), generator=g).to(dev, cfg.dtype)

        def norms():
            for _ in range(NORMS):
                common.apply_norm(cfg, {}, h)

        row = {"batch": B, "steps": args.steps, "tokens_ok": bool(check),
               "tok_s": B * args.steps / wall, "step_ms": wall / args.steps * 1e3,
               "step_device_ms": device_ms(step, 1), "step_host_ms": host_ms(step, args.reps),
               "norms_device_ms": device_ms(norms, args.reps),
               "norms_host_ms": host_ms(norms, args.reps)}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del srv, caches
    result = {"root": os.path.abspath(args.root), "card": card, "build_s": build_s,
              "rows": rows}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if all(r["tokens_ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
