"""Mixture-of-experts FFN: token-choice top-k routing with a capacity.

Counterpart of ``src/repro/models/moe.py``, the same function. The
reference builds one-hot ``(B, T, E, C)`` dispatch and combine tensors
and contracts them with einsums; here each routed (token, k) pair is
written into its expert's buffer row by index and its expert's output
gathered back by index, which selects the same rows and adds the same
products. Dispatch stays dense: every expert runs on its ``C`` buffer
rows every call, the rows nobody was routed to being zeros, as in the
reference. Nothing here reads the device from the host.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import ArchConfig, activation, dense, dense_init, expert_dense


def moe_init(cfg: ArchConfig, generator: torch.Generator, lead: tuple = (), *,
             device="cuda") -> dict:
    """The router (d, E) and the three (E, d, f) expert banks, each stacked
    under ``lead``."""
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = (2.0 / (d + f)) ** 0.5
    return {
        "router": dense_init(generator, d, E, lead, device=device),
        "we_gate": s * torch.randn(lead + (E, d, f), generator=generator, device=device),
        "we_up": s * torch.randn(lead + (E, d, f), generator=generator, device=device),
        "we_down": s * torch.randn(lead + (E, f, d), generator=generator, device=device),
    }


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Buffer rows an expert takes per batch row: ``cf * T * K / E``, at
    least ``K``. ``n_tokens`` is the T of the call, padding included."""
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(cap, cfg.top_k)


def route(cfg: ArchConfig, logits: torch.Tensor, C: int):
    """Top-k routing of float32 router logits (B, T, E) into buffers of C
    rows: returns the renormalised gates (B, T, K) with dropped pairs
    zeroed, the experts (B, T, K), each pair's buffer row (B, T, K), the
    kept mask, and the softmax and one-hot choices the balance loss
    reads. A pair's row is the count of earlier pairs routed to the same
    expert in the flattened (T*K) order, token-major, within its batch
    row; rows from C on are dropped. Ties go to the lower expert index,
    as ``jax.lax.top_k`` breaks them."""
    B, T, E = logits.shape
    K = cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = vals[..., :K], idx[..., :K]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    onehot = torch.nn.functional.one_hot(expert, E)                    # (B, T, K, E)
    flat = onehot.reshape(B, T * K, E)
    before = torch.cumsum(flat, dim=1) - flat
    pos = (before * flat).sum(-1).reshape(B, T, K)
    keep = pos < C
    return gate * keep, expert, pos, keep, probs, onehot


def moe_apply(cfg: ArchConfig, p, x: torch.Tensor, *, rows: str = "any",
              with_aux: bool = True):
    """x (B, T, d) -> (y, aux): ``aux`` holds the switch-style
    ``balance_loss`` and ``dropped_frac``, the share of (token, k) pairs
    past their expert's capacity; with ``with_aux`` False it is None and
    neither is computed. ``rows`` goes to every dense layer
    (``common.dense_rows``)."""
    dt = cfg.dtype
    B, T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    logits = dense(x, p["router"], dtype=dt, rows=rows).to(torch.float32)
    gate, expert, pos, keep, probs, onehot = route(cfg, logits, C)

    # dispatch: each kept pair's token into its expert's buffer row; the
    # dropped ones into a spare row C that no expert reads
    b_idx = torch.arange(B, device=x.device).reshape(B, 1, 1)
    slot = (b_idx * E + expert) * (C + 1) + torch.where(keep, pos, C)     # (B, T, K)
    buf = x.new_zeros((B * E * (C + 1), d))
    buf.index_copy_(0, slot.reshape(-1), x[:, :, None, :].expand(B, T, K, d).reshape(-1, d))
    xin = buf.reshape(B, E, C + 1, d)[:, :, :C]
    h = activation(cfg, expert_dense(xin, p["we_gate"], dtype=dt, rows=rows))
    h = h * expert_dense(xin, p["we_up"], dtype=dt, rows=rows)
    out = expert_dense(h, p["we_down"], dtype=dt, rows=rows)           # (B, E, C, d)

    # combine: each token's kept pairs, gate times its expert's output row,
    # added in k order
    rows_out = out.reshape(B, E * C, d)
    gathered = torch.gather(
        rows_out, 1, ((expert * C + torch.clamp(pos, max=C - 1)).reshape(B, T * K, 1)
                      .expand(B, T * K, d))).reshape(B, T, K, d)
    gathered = torch.where(keep[..., None], gathered, 0)
    g = gate.to(dt)
    y = g[..., 0, None] * gathered[:, :, 0]
    for k in range(1, K):
        y = y + g[..., k, None] * gathered[:, :, k]
    if not with_aux:
        return y, None

    me = probs.mean(dim=(0, 1))
    ce = onehot.sum(2).reshape(B * T, E).to(torch.float32).mean(0)
    balance_loss = E * torch.sum(me * ce)
    dropped = 1.0 - keep.to(torch.float32).mean()
    return y, {"balance_loss": balance_loss, "dropped_frac": dropped}
