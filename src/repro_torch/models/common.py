"""Shared model plumbing: config dataclass, norms, activations, init, and
the ONE dense-apply dispatch point of quantized-resident serving
(:func:`dense` and :func:`embed_lookup`).

Counterpart of ``src/repro/models/common.py`` for the decoders."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.plane_store import ShardedLeaf, on_device
from repro_torch.core.quantize import QuantizedTensor
from repro_torch.kernels import ops, ref


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture: the fields the dense decoders (olmo-1b,
    minitron-4b, starcoder2-15b, gemma3-27b), the mixture-of-experts
    decoders (mixtral-8x22b, dbrx-132b) and the recurrent ones
    (xlstm-125m, zamba2-7b) need, with the reference's defaults.
    ``cycle`` is the repeating pattern of block kinds; layers =
    ``len(cycle) * n_cycles + len(tail)``. The kinds ported: ``attn``, a
    full-attention decoder block with a GLU MLP; ``swa``, the same block
    attending over a sliding window of ``window`` positions (a ring
    cache); ``global``, full attention with a rope base 100x
    ``rope_theta`` (gemma3's naming); ``moe`` and ``swa_moe``, the
    ``attn`` and ``swa`` attention with a mixture-of-experts FFN
    (``n_experts`` experts, ``top_k`` a token, ``capacity_factor``);
    ``mamba2`` (a Mamba-2 SSD block: ``ssm_heads`` heads, ``ssm_state``,
    ``ssm_expand``, ``conv_width``, prefill in chunks of ``ssm_chunk``),
    ``mlstm`` and ``slstm`` (xLSTM's blocks, ``lstm_proj_factor``);
    ``shared_attn``, an ``attn`` block whose one set of weights every use
    shares (zamba2). The other kinds are still to be ported. ``head_dim``
    None means ``d_model // n_heads``. Float32 parameters before
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
    head_dim: int | None = None
    rope_theta: float = 10_000.0
    window: int = 0             # sliding-window span of swa blocks (0 = none)
    qk_norm: bool = False       # RMSNorm of each head's q and k before rope
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    act: str = "silu"           # silu | gelu (tanh approximation)
    attn_chunk: int = 1024      # online-softmax KV chunk of prefill attention
    tie_embeddings: bool = True
    logit_softcap: float = 0.0  # tanh cap of the output logits (0 = none)
    n_experts: int = 0          # experts of a moe block's FFN (0 = no moe)
    top_k: int = 0              # experts a token is routed to
    capacity_factor: float = 1.25  # expert buffer rows = cf * tokens * top_k / n_experts
    ssm_state: int = 0          # Mamba-2 state size N
    ssm_heads: int = 0          # Mamba-2 heads (0: d_inner // 64)
    ssm_expand: int = 2         # Mamba-2 d_inner = ssm_expand * d_model
    conv_width: int = 4         # Mamba-2 causal conv taps
    ssm_chunk: int = 256        # Mamba-2 prefill chunk of the SSD scan
    lstm_proj_factor: float = 2.0  # mLSTM d_inner = lstm_proj_factor * d_model
    dtype: Any = torch.bfloat16  # activations and KV caches

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def n_cycles(self) -> int:
        return self.n_layers // len(self.cycle)

    @property
    def tail(self) -> tuple[str, ...]:
        """Remainder blocks after the full cycles, continuing the pattern."""
        return self.cycle[:self.n_layers % len(self.cycle)]

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: same family/pattern, tiny dims (the
        reference's ``ArchConfig.reduced`` for the fields ported here)."""
        small = dict(
            n_layers=max(2, len(self.cycle)),
            d_model=min(self.d_model, 128),
            n_heads=min(self.n_heads, 4),
            n_kv=min(self.n_kv, 2),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=32 if self.head_dim else None,
            window=min(self.window, 16) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            # drop-free capacity (cf >= E/K), so that prefill equals decode
            # exactly; the published configs keep their cf
            capacity_factor=4.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=min(self.ssm_heads, 2) if self.ssm_heads else 0,
            attn_chunk=16,
            ssm_chunk=8,
            dtype=torch.float32,
        )
        if small["n_heads"] % max(small["n_kv"], 1):
            small["n_kv"] = 1
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Norms, activations, init
# ---------------------------------------------------------------------------

NORM_TYPES = ("rmsnorm", "layernorm", "nonparam_ln")
ACTIVATIONS = ("silu", "gelu")


def norm_init(cfg: ArchConfig, d: int, lead: tuple = (), *, device="cuda") -> dict:
    """RMSNorm has a scale, LayerNorm a scale and a bias, OLMo's
    non-parametric LayerNorm nothing; ``lead`` stacks them (a layer
    stack's ``(n, d)``)."""
    if cfg.norm_type == "rmsnorm":
        return {"scale": torch.ones(lead + (d,), device=device)}
    if cfg.norm_type == "layernorm":
        return {"scale": torch.ones(lead + (d,), device=device),
                "bias": torch.zeros(lead + (d,), device=device)}
    if cfg.norm_type == "nonparam_ln":
        return {}
    raise ValueError(f"norm_type {cfg.norm_type!r} not in {NORM_TYPES}")


def apply_norm(cfg: ArchConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The reference's norms, each one PyTorch launch whose CUDA kernel
    gives each row a block of a fixed shape, so a row's statistics, and
    with them a decode row and a verify row, do not depend on how many
    rows share the launch (separate mean and variance reductions do:
    PyTorch picks their thread layout from the number of rows). That is
    the kernels' design, not a documented guarantee:
    ``tests/test_torch_gpu.py::test_norm_rows_independent_of_count``
    holds it on the card at the widths the port runs.

    OLMo's non-parametric LayerNorm takes x as it is (statistics in
    float32 inside ``F.layer_norm``). RMSNorm (eps 1e-6) and the affine
    LayerNorm (eps 1e-5) normalise a float32 copy of x with their float32
    parameters and round once to x's dtype, as the reference does."""
    if cfg.norm_type == "nonparam_ln":
        return F.layer_norm(x, x.shape[-1:], eps=1e-5)
    xf = x.to(torch.float32)
    if cfg.norm_type == "rmsnorm":
        y = F.rms_norm(xf, x.shape[-1:], weight=p["scale"], eps=1e-6)
    elif cfg.norm_type == "layernorm":
        y = F.layer_norm(xf, x.shape[-1:], weight=p["scale"], bias=p["bias"], eps=1e-5)
    else:
        raise ValueError(f"norm_type {cfg.norm_type!r} not in {NORM_TYPES}")
    return y.to(x.dtype)


def activation(cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """SiLU, or GELU's tanh approximation (``jax.nn.gelu``'s default;
    ``F.gelu``'s default is the erf form)."""
    if cfg.act == "silu":
        return F.silu(x)
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"act {cfg.act!r} not in {ACTIVATIONS}")


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
# Under a serving mesh a weight split on its output dim, or an expert
# bank split on its expert dim, is a ShardedLeaf (core/plane_store.py):
# its product runs a shard at a time (ops.sharded_dequant_matmul, a
# matmul a shard for float leaves, or a shard's experts) and the outputs
# are gathered on x's device, the mesh's home device, where
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


def expert_dense(x: torch.Tensor, w, *, dtype, rows: str = "any") -> torch.Tensor:
    """The per-expert matmul ``einsum('becd,edf->becf')``: x (B, E, C, d)
    holds each expert's C buffer rows, w the (E, d, f) bank. A
    QuantizedTensor bank makes one ``ops.dequant_matmul`` a expert on its
    (B*C, d) rows, with the expert's own ``q`` (a view of the store's
    buffer), its (1, 1) ``scale`` and ``offset`` (banks sliced per expert
    keep a range each) and its own ``keep`` plane mask; ``rows`` as
    :func:`dense`. A float bank is one einsum in ``dtype``. A
    :class:`ShardedLeaf` bank split on its expert dim runs a shard at a
    time (:func:`_expert_dense_sharded`)."""
    if isinstance(w, ShardedLeaf):
        return _expert_dense_sharded(x, w, dtype=dtype, rows=rows)
    if isinstance(w, QuantizedTensor):
        B, E, C, d = x.shape
        outs = []
        for e in range(E):
            ye = ops.dequant_matmul(x[:, e].reshape(B * C, d), w.q[e], w.scale[e],
                                    w.offset[e],
                                    None if w.keep_bits is None else w.keep_bits[e],
                                    bits=w.bits, rows=rows)
            outs.append(ye.reshape(B, C, -1))
        return torch.stack(outs, dim=1).to(dtype)
    return torch.einsum("becd,edf->becf", x, w.to(dtype))


def _expert_dense_sharded(x: torch.Tensor, w: ShardedLeaf, *, dtype, rows: str
                          ) -> torch.Tensor:
    """Shard j's experts ``[e0, e1)`` of a bank split on its expert dim:
    x's slice of experts goes to the shard's device (no copy for logical
    shards of x's), :func:`expert_dense` runs there on the shard's part
    (one B2 launch an expert, with the expert's own affine and mask, or
    one einsum), and the outputs come back to x's device in expert
    order. An expert's N is never split, so every expert's output equals
    the unsharded call's."""
    if w.axis != -3:
        raise ValueError(f"an expert bank split on axis {w.axis}, not its expert dim")
    outs, e0 = [], 0
    for part, size, dev in zip(w.parts, w.sizes(), w.mesh.model_devices):
        xj = x[:, e0:e0 + size]
        with on_device(dev):
            y = expert_dense(xj if xj.device == dev else xj.to(dev, non_blocking=True), part,
                             dtype=dtype, rows=rows)
        outs.append(y if y.device == x.device else y.to(x.device, non_blocking=True))
        e0 += size
    return torch.cat(outs, dim=1)


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


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """``tanh(x / cap) * cap``; the identity when ``cap`` is 0."""
    return torch.tanh(x / cap) * cap if cap else x
