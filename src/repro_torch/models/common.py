"""Shared model plumbing: config dataclass, norms, activations, init, and
the ONE dense-apply dispatch point of quantized-resident serving
(:func:`dense` and :func:`embed_lookup`).

Counterpart of ``src/repro/models/common.py`` for the dense decoder."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture: the fields the dense decoder (olmo-1b) needs.
    ``cycle`` names the block kind of the stacked layers (``attn``, a
    full-attention decoder block with a GLU MLP; the other kinds are
    still to be ported). Tied embeddings, float32 parameters before
    division."""

    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    cycle: tuple[str, ...] = ("attn",)
    rope_theta: float = 10_000.0
    norm_type: str = "nonparam_ln"
    act: str = "silu"
    attn_chunk: int = 1024      # online-softmax KV chunk of prefill attention
    dtype: Any = torch.bfloat16  # activations and KV caches

    @property
    def hd(self) -> int:
        return self.d_model // self.n_heads

    @property
    def n_cycles(self) -> int:
        return self.n_layers // len(self.cycle)

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims (the
        reference's ``ArchConfig.reduced`` for the fields ported here)."""
        small = dict(
            n_layers=max(2, len(self.cycle)),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv=min(self.n_kv, 2),
            d_ff=min(self.d_ff, 256),
            vocab=min(self.vocab, 512),
            attn_chunk=16,
            dtype=torch.float32,
        )
        if small["n_heads"] % max(small["n_kv"], 1):
            small["n_kv"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Norms, activations, init
# ---------------------------------------------------------------------------

def _ported(cfg: ArchConfig) -> None:
    if cfg.norm_type != "nonparam_ln" or cfg.act != "silu":
        raise NotImplementedError(
            f"norm {cfg.norm_type!r} / activation {cfg.act!r} are still to be "
            "ported (ROADMAP A8); the port has OLMo's nonparam_ln and silu")


def norm_init(cfg: ArchConfig) -> dict:
    """OLMo's LayerNorm has no affine parameters."""
    _ported(cfg)
    return {}


def apply_norm(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    _ported(cfg)
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def activation(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    _ported(cfg)
    return F.silu(x)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, lead: tuple = (),
               *, device="cuda") -> torch.Tensor:
    scale = (2.0 / (d_in + d_out)) ** 0.5
    return scale * torch.randn(lead + (d_in, d_out), generator=generator, device=device)


# ---------------------------------------------------------------------------
# Quantized-resident dispatch
#
# Every matmul of the model goes through dense(); the embedding gather
# through embed_lookup(). A parameter leaf is either a float tensor
# (plain matmul) or a live QuantizedTensor over the PlaneStore
# accumulators, whose product runs through ops.dequant_matmul: the float
# weight never exists in device memory.
# ---------------------------------------------------------------------------

# Leaf basenames consumed only through the dispatch helpers, which may
# therefore stay quantized (the reference's set).
QUANTIZED_RESIDENT_LEAVES = frozenset({
    "wq", "wk", "wv", "wo", "wi_gate", "wi_up",
    "router", "we_gate", "we_up", "we_down",
    "embed", "lm_head", "vision_proj",
    "in_proj", "out_proj", "up_proj", "down_proj",
    "w_in", "w_if",
})


def leaf_basename(key) -> str:
    """Last component of a leaf key: a path tuple or an 'a/b/c' string."""
    if isinstance(key, str):
        return key.rsplit("/", 1)[-1]
    return str(key[-1])


def quantized_resident_eligible(key) -> bool:
    """The default ``eligible`` predicate of
    :meth:`~repro_torch.core.plane_store.PlaneStore.quantized_leaves`."""
    return leaf_basename(key) in QUANTIZED_RESIDENT_LEAVES


def masked_q(w: QuantizedTensor, q: torch.Tensor | None = None) -> torch.Tensor:
    """The accumulator a consumer reads. Truncated-precision views (a
    deferred plane mask) belong to self-speculation, not ported yet, so
    this is the identity."""
    return w.q if q is None else q


def dense(x: torch.Tensor, w, *, dtype) -> torch.Tensor:
    """``x @ w`` with ``w`` either a float tensor (cast to ``dtype``,
    plain matmul) or a QuantizedTensor (fused dequant-matmul, float32
    accumulation, output cast to ``dtype``). x: (..., K); w: (K, N)."""
    if isinstance(w, QuantizedTensor):
        lead = x.shape[:-1]
        y = ops.dequant_matmul(x.reshape(-1, x.shape[-1]), masked_q(w), w.scale, w.offset)
        return y.reshape(*lead, w.q.shape[-1]).to(dtype)
    return x @ w.to(dtype)


# PyTorch's CUDA indexing has no uint16/uint32 kernels; rows are gathered
# through a signed view of the same bytes and viewed back.
_GATHER_VIEW = {torch.uint8: torch.uint8, torch.uint16: torch.int16,
                torch.uint32: torch.int32}


def embed_lookup(w, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-row gather. The quantized path gathers the *uint* rows
    and applies the eq.-(5) affine to just those rows: the float table
    never exists. Returns float32 rows (callers cast)."""
    if isinstance(w, QuantizedTensor):
        q = masked_q(w)
        rows = q.view(_GATHER_VIEW[q.dtype])[tokens].view(q.dtype).to(torch.float32)
        return rows * w.scale.reshape(()) + w.offset.reshape(())
    return w[tokens].to(torch.float32)

