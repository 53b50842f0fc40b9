"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt family, scaled per assignment]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv=16,
    d_ff=21504,
    vocab=262144,
    head_dim=128,
    cycle=("swa",) * 5 + ("global",),  # 5:1 local:global
    window=1024,
    qk_norm=True,
    rope_theta=10_000.0,
    logit_softcap=30.0,
    act="gelu",
)
