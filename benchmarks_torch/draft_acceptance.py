#!/usr/bin/env python3
"""How often the self-speculative draft is accepted on full-width olmo-1b
with seeded random weights, some of them scaled, on one NVIDIA GPU, from
the checkout at ``--root`` (default: this one).

    python3 benchmarks_torch/draft_acceptance.py [--root DIR]
        [--scales embed:0.3 decoder:2 ...] [--draft-bits 4 2]

The weights as initialised (seed 0) make a model that repeats each
slot's last token: the residual stream keeps the input token's own
embedding on top and the unembedding is tied, so any prefix of the
planes predicts the target exactly. Scaling the decoder's weights up, or
the embedding down, lets the layers pick the next token. For each scale
and draft width it divides the scaled model, serves all 8 stages, and
prints on a line of its own: the plain server's 24 tokens from a (4, 64)
prompt (torch generator, seed 1) and their count of distinct tokens; the
``SpeculativeEngine`` (k = 4) tokens' equality to them; drafted and
accepted; rounds with a slot accepting part of its drafts, and rounds
whose slots accepted different counts. Needs a CUDA device; exits 2
without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

PROMPT, TOKENS = 64, 24


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--scales", nargs="+", default=[
        "embed:0.3", "embed:0.1", "embed:0.05", "embed:0.03", "embed:0.01",
        "decoder:1.5", "decoder:2", "decoder:3"])
    ap.add_argument("--draft-bits", type=int, nargs="+", default=[4, 2])
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.root), "src"))
    if not torch.cuda.is_available():
        print("draft_acceptance: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.progressive import divide
    from repro_torch.kernels import build
    from repro_torch.models.model import build_model
    from repro_torch.serving import ProgressiveServer, SpecConfig, SpeculativeEngine

    build.build_all()
    dev = torch.device("cuda")
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    prompt = torch.randint(0, cfg.vocab, (4, PROMPT), generator=torch.Generator().manual_seed(1))

    def scaled(tree, f):
        if isinstance(tree, dict):
            return {k: scaled(v, f) for k, v in tree.items()}
        return tree * f

    for spec in args.scales:
        which, f = spec.split(":")
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
        params[which] = scaled(params[which], float(f))
        prog = divide(params)
        del params
        srv = ProgressiveServer(model, prog, max_len=PROMPT + TOKENS, resident="quantized",
                                device=dev)
        for _ in range(prog.n_stages):
            srv.receive_stage()
        srv.start({"tokens": prompt})
        want = srv.decode(TOKENS).tokens.cpu()
        del srv
        for bits in args.draft_bits:
            eng = SpeculativeEngine(model, prog, max_len=PROMPT + TOKENS + 9,
                                    spec=SpecConfig(draft_bits=bits, k=4), device=dev)
            for _ in range(prog.n_stages):
                eng.receive_stage()
            eng.start({"tokens": prompt})
            res = eng.decode(TOKENS)
            rounds = [r for r in res.accept_rounds if r["k"]]
            print(json.dumps({
                "scale": which, "f": float(f), "draft_bits": bits,
                "tokens_equal": bool(torch.equal(res.tokens, want)),
                "distinct": len(set(want.reshape(-1).tolist())),
                "drafted": res.drafted, "accepted": res.accepted, "rounds": len(rounds),
                "partial": sum(1 for r in rounds
                               if any(0 < n < r["k"] for n in r["accepted"])),
                "ragged": sum(1 for r in rounds if len(set(r["accepted"])) > 1),
                "s": time.perf_counter() - t0}), flush=True)
            del eng
        del prog
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
