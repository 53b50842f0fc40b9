"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (kv=16) d_ff=4096
vocab=256206; encoder-decoder, multimodal: 12 bidirectional encoder
blocks over the speech frames, 12 decoder blocks of self-attention then
attention over the encoder's output. The audio frontend (mel filterbank
and conv feature extractor) is a stub: ``enc_input`` carries the frame
embeddings. [arXiv:2308.11596]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=256206,
    cycle=("selfcross",),
    enc_layers=12,
    enc_seq_divisor=4,
    norm_type="layernorm",
    act="gelu",
    tie_embeddings=True,
)
