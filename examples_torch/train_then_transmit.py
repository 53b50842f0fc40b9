"""End-to-end driver on the PyTorch port: train a small model for a few
hundred steps, save a PROGRESSIVE checkpoint, then cold-start inference
from each precision prefix — the deployment loop the paper proposes, on
the training side.

    PYTHONPATH=src python examples_torch/train_then_transmit.py [--steps 300] \\
        [--arch olmo-1b] [--device cuda|cpu]

The port's counterpart of ``examples/train_then_transmit.py``, with its
flags, reduced config and lines, in two halves: :func:`train_model`
trains (``train/loop.train``, its init from a generator seeded 0 where the
reference draws ``jax.random.PRNGKey(0)``), and :func:`transmit` saves
any params as a progressive checkpoint under ``tempfile.gettempdir()``
and measures held-out accuracy at each prefix of it (``checkpoint.
load_into``) and for the params themselves, so a test can hand it the
reference's trained params. The full-width model trains, checkpoints and
serves from its checkpoint on the card in ``chip_smoke.py``'s
``[train]``. ``--device`` is ``cuda`` by default and raises without a
card; ``--device cpu`` runs every kernel's plain version.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device, to_device
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, MarkovMotifDataset
from repro_torch.train.loop import train


def reduced_model(arch: str):
    cfg = get_config(arch).reduced(n_layers=2, d_model=128, d_ff=256, vocab=64, n_heads=4,
                                   n_kv=4)
    return build_model(cfg)


def train_model(model, steps: int, *, device):
    """The training half: ``steps`` steps of the motif data at batch 16 x
    64; prints the logged steps and returns ``train``'s result."""
    cfg = model.cfg
    res = train(model, steps=steps,
                data_cfg=DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=16),
                opt_cfg=opt.OptConfig(lr=1e-2, warmup_steps=20, total_steps=steps),
                log_every=max(steps // 10, 1), device=device)
    for h in res.history:
        print(f"  step {h['step']:4d}  loss {h['loss']:.3f}  grad_norm {h['grad_norm']:.2f}")
    return res


def transmit(model, params, *, device) -> dict:
    """The evaluation half: save ``params`` as a progressive checkpoint,
    print its manifest, and the accuracy of a held-out batch (64 x 64
    labels) at each prefix of stages and for ``params``. Returns the
    manifest, ``correct`` (labels right, by stage count; 0 for the
    params), ``accuracy`` likewise, and ``labels``."""
    ckpt_dir = os.path.join(tempfile.gettempdir(), "progressive_ckpt")
    print(f"\n== saving progressive checkpoint to {ckpt_dir} ==")
    checkpoint.save(params, ckpt_dir)
    man = checkpoint.manifest(ckpt_dir)
    print(f"  header {man['header_bytes']}B + stages "
          f"{[man['stage_bytes'][s] for s in sorted(man['stage_bytes'])]}")

    # held-out evaluation at each cold-start precision
    ds = MarkovMotifDataset(DataConfig(vocab=model.cfg.vocab, seq_len=64, global_batch=64,
                                       seed=0))
    batch = {k: to_device(v, device) for k, v in ds.batch(10_000).items()}

    def predict(p) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = model.forward(p, batch)
        return logits.argmax(-1)

    out = {"manifest": man, "correct": {}, "accuracy": {}, "predictions": {},
           "labels": batch["labels"].cpu()}

    def score(stages: int, p) -> float:
        pred = predict(p)
        out["predictions"][stages] = pred.cpu()
        out["correct"][stages] = int((pred == batch["labels"]).sum())
        out["accuracy"][stages] = out["correct"][stages] / batch["labels"].numel()
        return out["accuracy"][stages]

    print("\n== cold-start accuracy by checkpoint prefix ==")
    full_acc = score(0, params)
    for stages in range(1, 9):
        approx = checkpoint.load_into(ckpt_dir, params, stages=stages, device=device)
        bytes_read = man["header_bytes"] + sum(
            man["stage_bytes"][s] for s in range(1, stages + 1))
        print(f"  stages 1..{stages} ({2 * stages:2d} bits, "
              f"{bytes_read / 1e6:.2f} MB): accuracy {score(stages, approx):.3f}")
    print(f"  fp32 reference: {full_acc:.3f}")
    return out


def main(argv: list[str] | None = None) -> dict:
    """Train, checkpoint and evaluate; returns :func:`transmit`'s result
    with ``history``, the logged training steps."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    model = reduced_model(args.arch)
    print(f"== training {args.arch} (reduced) for {args.steps} steps ==")
    res = train_model(model, args.steps, device=device)
    out = transmit(model, res.params, device=device)
    out["history"] = res.history
    return out


if __name__ == "__main__":
    main()
