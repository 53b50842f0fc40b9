#!/usr/bin/env python3
"""Time eager greedy decoding of full-width olmo-1b before and after a
``torch.profiler`` session in the same process, on one NVIDIA GPU.

    python3 benchmarks_torch/profiler_overhead.py [--control] [--batch 4] [--steps 32]
                                                   [--out FILE]

The model is full-width olmo-1b (16 layers, d_model 2048) with seeded
random weights, divided into 8 stages of 2-bit planes and served by
``ProgressiveServer(resident="quantized")`` after all 8 stages, from a
64-token prompt. Each measurement prints a JSON line: ``step_ms``, a step
of ``decode(steps)`` by the host's clock, synchronised at the end (the
eager path as a user runs it; host-bound), and ``step_host_ms``, the host
time to issue one ``decode_step``. Two measurements are taken, then one
``decode_step`` runs under ``torch.profiler.profile`` with the CPU and
CUDA activities (as ``chip_smoke.py``'s training phase profiles a
step), then two more. With ``--control`` the profiler session is left
out, so the drift between the two pairs shows alone; run both ways in
turns on one machine to compare.

``--device cpu`` runs the same sequence on reduced olmo-1b on the CPU
(a smoke run; its times are no device's). Needs a CUDA device otherwise;
exits 2 without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

PROMPT, WARMUP = 64, 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--control", action="store_true", help="leave the profiler session out")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the results as JSON here")
    args = ap.parse_args()
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("profiler_overhead: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.models.model import build_model
    from repro_torch.serving import ProgressiveServer

    card = "cpu"
    if on_card:
        from repro_torch.kernels import build

        build.build_all()
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = get_config("olmo-1b")
    if not on_card:
        cfg = dataclasses.replace(cfg.reduced(), n_layers=4)
    model = build_model(cfg)
    prog = divide(model.init(torch.Generator(device=dev).manual_seed(args.seed), device=dev))
    g = torch.Generator().manual_seed(args.seed + 1)
    srv = ProgressiveServer(model, prog, max_len=PROMPT + WARMUP + 5 * args.steps + 1,
                            resident="quantized", device=dev)
    for _ in range(prog.n_stages):
        srv.receive_stage()
    srv.start({"tokens": torch.randint(0, cfg.vocab, (args.batch, PROMPT), generator=g)})
    srv.decode(WARMUP)
    tok = torch.zeros((args.batch, 1), dtype=torch.int32, device=dev)

    def step():
        model.decode_step(srv.params, srv.caches, tok, srv.pos)

    def measure(when: str) -> dict:
        sync()
        t0 = time.perf_counter()
        srv.decode(args.steps)
        sync()
        wall = time.perf_counter() - t0
        sync()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            step()
        host = (time.perf_counter() - t0) / args.reps * 1e3
        sync()
        row = {"when": when, "step_ms": wall / args.steps * 1e3, "step_host_ms": host}
        print(json.dumps(row), flush=True)
        return row

    rows = [measure("before"), measure("before")]
    if not args.control:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            step()
            sync()
        prof.key_averages()
    rows += [measure("after"), measure("after")]
    result = {"card": card, "control": args.control, "batch": args.batch,
              "steps": args.steps, "rows": rows}
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
