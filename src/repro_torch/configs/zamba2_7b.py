"""zamba2-7b [hybrid] — 81L d_model=3584 32H (kv=32) d_ff=14336
vocab=32000, ssm_state=64; Mamba2 blocks + one shared attention block
applied at intervals (per-use LoRA omitted, as in the reference).
[arXiv:2411.15242]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_ff=14336,
    vocab=32000,
    cycle=("mamba2",) * 5 + ("shared_attn",),
    ssm_state=64,
    ssm_heads=112,   # d_inner=7168, head dim 64
    ssm_expand=2,
)
