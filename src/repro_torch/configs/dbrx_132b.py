"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352; fine-grained MoE, 16 experts top-4.
[hf:databricks/dbrx-base]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv=8,
    d_ff=10752,
    vocab=100352,
    cycle=("moe",),
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    tie_embeddings=False,
)
