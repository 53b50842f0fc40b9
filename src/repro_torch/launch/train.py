"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --device cpu --steps 200 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --steps 2 \\
        --ckpt-dir DIR --ckpt-every 2

Counterpart of ``src/repro/launch/train.py``, with its flags and output
lines (a JSON line per logged step, then ``loss A -> B over N steps``),
and ``--device`` (default ``cuda``, which raises without a card; ``cpu``
runs every kernel's plain version). The loop saves *progressive*
checkpoints (header and bit-plane stages), the paper's artifact: a
checkpoint a server can cold-start from at 2 bits. An encoder or vision
arch's memory input is zeros, as the reference launcher makes it.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import train


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the kernels' plain versions)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, seed=args.seed)

    def extra(batch):
        B, S = batch["tokens"].shape
        mem = cfg.memory_input(S)
        if mem is not None:
            batch[mem[0]] = torch.zeros((B,) + mem[1], dtype=cfg.dtype, device=device)
        return batch

    result = train(
        model,
        steps=args.steps,
        data_cfg=data_cfg,
        opt_cfg=opt.OptConfig(lr=args.lr, total_steps=args.steps),
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        log_every=args.log_every,
        seed=args.seed,
        extra_batch=extra,
        device=device,
    )
    for h in result.history:
        print(json.dumps({k: round(v, 4) if isinstance(v, float) else v
                          for k, v in h.items()}))
    first, last = result.history[0]["loss"], result.history[-1]["loss"]
    print(f"loss {first:.4f} -> {last:.4f} over {args.steps} steps")


if __name__ == "__main__":
    main()
