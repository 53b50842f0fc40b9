"""Shared model plumbing: config dataclass, norms, activations, init, and
the ONE dense-apply dispatch point of quantized-resident serving
(:func:`dense` and :func:`embed_lookup`).

Counterpart of ``src/repro/models/common.py`` for the dense decoder."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.plane_store import ShardedLeaf
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import ops, ref


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
    window: int = 0             # sliding-window span (0 = full attention)
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
    """OLMo's non-parametric LayerNorm, statistics in float32, in one
    ``F.layer_norm`` launch. Its CUDA kernel gives each row a block of a
    fixed shape, so a row's mean and variance, and with them a decode row
    and a verify row, do not depend on how many rows share the launch
    (separate mean and variance reductions do: PyTorch picks their
    thread layout from the number of rows). That is the kernel's design,
    not a documented guarantee: ``tests/test_torch_gpu.py::
    test_norm_rows_independent_of_count`` holds it on the card at the
    widths the port runs."""
    _ported(cfg)
    return F.layer_norm(x, x.shape[-1:], eps=1e-5)


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
#
# Under a serving mesh a weight split on its output dim is a ShardedLeaf
# (core/plane_store.py): its product runs a shard at a time
# (ops.sharded_dequant_matmul, or a matmul a shard for float leaves) and
# the outputs are gathered on x's device, the mesh's home device, where
# attention, norms, caches and sampling run once: the counterpart of the
# reference pinning every activation replicated. No contraction is ever
# split, so no partial sums are added.
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


def masked_q(w: QuantizedTensor, q: torch.Tensor | None = None,
             keep: torch.Tensor | None = None) -> torch.Tensor:
    """A truncated view's deferred plane mask applied to ``q`` (default
    ``w.q``): its top ``keep_bits`` of ``w.bits`` bits, widened to int32
    (int64 for uint32) for the shifts and cast back. The identity for a
    view without ``keep_bits``. :func:`dense` never calls it: it hands
    the mask to the kernel as an operand; :func:`embed_lookup` masks only
    the rows it gathers."""
    q = w.q if q is None else q
    keep = w.keep_bits if keep is None else keep
    return ref.mask_q(q, keep, w.bits)


def dense_rows(mode: str) -> str:
    """The ``rows`` of every dense layer in ``mode``: decode and verify
    keep each row's result independent of the rows beside it, so that a
    verify row equals the decode step of its token bit for bit (see
    ``Model.verify_step``)."""
    return "decode" if mode in ("decode", "verify") else "any"


def dense(x: torch.Tensor, w, *, dtype, rows: str = "any") -> torch.Tensor:
    """``x @ w`` with ``w`` either a float tensor (cast to ``dtype``,
    plain matmul) or a QuantizedTensor (fused dequant-matmul, float32
    accumulation, output cast to ``dtype``; a truncated view's plane
    mask goes to the kernel as the ``keep`` operand). ``rows`` is the
    kernel's (``"decode"``: a row's result does not depend on how many
    rows share the launch). x: (..., K); w: (K, N), or a
    :class:`ShardedLeaf` split on N (``ops.sharded_dequant_matmul``, or a
    matmul a shard, gathered on x's device)."""
    if isinstance(w, ShardedLeaf):
        return _dense_sharded(x, w, dtype=dtype, rows=rows)
    if isinstance(w, QuantizedTensor):
        lead = x.shape[:-1]
        y = ops.dequant_matmul(x.reshape(-1, x.shape[-1]), w.q, w.scale, w.offset,
                               w.keep_bits, bits=w.bits, rows=rows)
        return y.reshape(*lead, w.q.shape[-1]).to(dtype)
    return x @ w.to(dtype)


def _dense_sharded(x: torch.Tensor, w: ShardedLeaf, *, dtype, rows: str) -> torch.Tensor:
    if w.axis != -1:
        raise ValueError(f"a dense weight split on axis {w.axis} would shard a contraction")
    lead, N = x.shape[:-1], w.shape[-1]
    x2 = x.reshape(-1, x.shape[-1])
    if w.quantized:
        p0 = w.parts[0]
        y = ops.sharded_dequant_matmul(
            x2, [p.q for p in w.parts], [p.scale for p in w.parts],
            [p.offset for p in w.parts],
            keeps=None if p0.keep_bits is None else [p.keep_bits for p in w.parts],
            bits=p0.bits, rows=rows, mesh=w.mesh)
        return y.reshape(*lead, N).to(dtype)
    outs = [(x2 if p.device == x.device else x2.to(p.device, non_blocking=True))
            @ p.to(dtype) for p in w.parts]
    y = torch.cat([o if o.device == x.device else o.to(x.device, non_blocking=True)
                   for o in outs], dim=-1)
    return y.reshape(*lead, N)


# PyTorch's CUDA indexing has no uint16/uint32 kernels; rows are gathered
# through a signed view of the same bytes and viewed back.
_GATHER_VIEW = {torch.uint8: torch.uint8, torch.uint16: torch.int16,
                torch.uint32: torch.int32}


def embed_lookup(w, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-row gather. The quantized path gathers the *uint* rows
    and applies the eq.-(5) affine to just those rows: the float table
    never exists; a truncated view's mask applies to the gathered rows
    only. Returns float32 rows (callers cast). Under a serving mesh the
    table is gathered whole on the home device
    (``launch.sharding.GATHERED_LEAVES``)."""
    if isinstance(w, QuantizedTensor):
        q = w.q
        rows = masked_q(w, q.view(_GATHER_VIEW[q.dtype])[tokens].view(q.dtype))
        return rows.to(torch.float32) * w.scale.reshape(()) + w.offset.reshape(())
    return w[tokens].to(torch.float32)

