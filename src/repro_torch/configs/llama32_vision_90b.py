"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; a gated cross-attention image layer every 5th
layer. The vision encoder (ViT) is a stub: ``vision_embeds`` carries the
patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision, scaled per the
reference's assignment]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=28672,
    vocab=128256,
    cycle=("attn",) * 4 + ("cross",),
    rope_theta=500_000.0,
    vision_tokens=1601,   # 1 tile of 560x560 / 14px patches + cls
    d_vision=1280,
    tie_embeddings=False,
)
