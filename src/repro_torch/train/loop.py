"""Training loop: a train step under autograd, metrics, and periodic
progressive checkpoints.

Counterpart of ``src/repro/train/loop.py``. The reference jits
``value_and_grad`` of ``Model.loss`` and the optimizer update; here the
step runs eagerly: ``Model.loss`` in ``full`` mode (each cycle of layers
rematerialised under ``cfg.remat``), ``torch.autograd.grad`` for the
gradients, then :func:`optimizer.update`, which writes the params and the
state in place. Batches come from the data's ``Prefetcher`` thread and
reach the device through pinned memory (``repro_torch.to_device``);
metrics stay on the device and are read to the host only at
``log_every`` steps and the last one, as the reference reads them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch import resolve_device, to_device
from repro_torch.core.progressive import tree_flatten_with_path, tree_skeleton, tree_unflatten
from repro_torch.models.model import Model
from repro_torch.train import checkpoint
from repro_torch.train import optimizer as opt
from repro_torch.train.data import DataConfig, MarkovMotifDataset, Prefetcher


def make_train_step(model: Model, ocfg: opt.OptConfig) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradient with respect to every leaf of
    ``params`` (which must require grad), then AdamW in place. ``metrics``
    holds ``loss``, the loss's metrics (``ce``, ``balance_loss``,
    ``dropped_frac``) and ``grad_norm`` and ``lr``, device scalars."""
    def train_step(params, opt_state, batch):
        paths, leaves = zip(*tree_flatten_with_path(params))
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        grads = tree_unflatten(tree_skeleton(params), dict(zip(paths, grads)))
        params, opt_state, opt_metrics = opt.update(ocfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(),
                                   **{k: v.detach() for k, v in metrics.items()},
                                   **opt_metrics}

    return train_step


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    history: list[dict]


def _with_grad(tree):
    if isinstance(tree, dict):
        return {k: _with_grad(v) for k, v in tree.items()}
    return tree.requires_grad_(True)


def train(
    model: Model,
    *,
    steps: int,
    data_cfg: DataConfig,
    opt_cfg: opt.OptConfig | None = None,
    ckpt_dir: str | None = None,
    ckpt_every: int = 0,
    log_every: int = 10,
    seed: int = 0,
    extra_batch: Callable[[dict], dict] | None = None,
    device="cuda",
) -> TrainResult:
    """Train ``model`` from ``Model.init`` with a generator seeded by
    ``seed`` on ``device`` for ``steps`` steps of ``data_cfg``'s
    ``MarkovMotifDataset``; ``extra_batch`` adds inputs to each device
    batch (a cross-attention arch's memory). Every ``ckpt_every`` steps the
    params go to ``ckpt_dir`` as a progressive checkpoint. ``history``
    holds a dict of host floats for step 0, every ``log_every``-th step and
    the last, with ``step`` and ``wall_s``."""
    device = resolve_device(device)
    opt_cfg = opt_cfg or opt.OptConfig(total_steps=steps)
    params = _with_grad(model.init(torch.Generator(device=device).manual_seed(seed),
                                       device=device))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt_cfg)

    ds = MarkovMotifDataset(data_cfg)
    pf = Prefetcher(ds)
    history = []
    t0 = time.time()
    try:
        for step in range(steps):
            batch = {k: to_device(v, device) for k, v in pf.next().items()}
            if extra_batch:
                batch = extra_batch(batch)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step % log_every == 0 or step == steps - 1:
                host = torch.stack([v.to(torch.float32) for v in metrics.values()]).tolist()
                m = dict(zip(metrics, host))
                m["step"] = step
                m["wall_s"] = time.time() - t0
                history.append(m)
            if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
                checkpoint.save(params, ckpt_dir)
    finally:
        pf.close()
    return TrainResult(params=params, opt_state=opt_state, history=history)
