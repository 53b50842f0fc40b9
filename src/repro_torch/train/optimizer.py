"""AdamW with a warmup-cosine schedule, as plain float32 tensor ops.

Counterpart of ``src/repro/train/optimizer.py``: the same schedule, the
same clip by the global norm, and the same update,
``p - lr * (mhat / (sqrt(vhat) + eps) + weight_decay * p)``, whose
``eps`` and decoupled decay sit where ``torch.optim.AdamW`` does not put
them. State is a tree like the params (``mu``, ``nu``) and a device int32
``step``. The reference's jitted step donates params and state; here
:func:`update` writes them in place, so a step holds no second copy of
either.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.progressive import tree_flatten_with_path


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    grad_clip: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a float32 tensor): linear warmup over
    ``warmup_steps``, then a cosine from ``lr`` down to ``0.1 * lr`` at
    ``total_steps``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init(params) -> dict:
    """Zeroed moments shaped like ``params`` and a step counter of 0 (int32,
    on the params' device)."""
    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        return torch.zeros_like(tree, requires_grad=False)

    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)}


def _leaves(tree) -> list[torch.Tensor]:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def global_norm(tree) -> torch.Tensor:
    """The square root of the sum, leaf by leaf in sorted-key order, of
    each leaf's float32 sum of squares."""
    total = torch.zeros((), dtype=torch.float32, device=_leaves(tree)[0].device)
    for g in _leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: OptConfig, grads, state: dict, params):
    """One AdamW step. ``grads`` is a tree like ``params``. Writes the new
    params, moments and step into ``params`` and ``state`` in place and
    returns ``(params, state, {"grad_norm", "lr"})``, the metrics as
    device scalars (nothing is read to the host)."""
    state["step"].add_(1)
    step = state["step"].to(torch.float32)
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for p, m, v, g in zip(_leaves(params), _leaves(state["mu"]), _leaves(state["nu"]),
                          _leaves(grads)):
        g = g * clip
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        p.copy_(p - lr * (m / bc1 / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p))
    return params, state, {"grad_norm": gnorm, "lr": lr}
