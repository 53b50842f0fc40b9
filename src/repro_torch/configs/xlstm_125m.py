"""xlstm-125m [ssm] — 12L d_model=768 4H d_ff=0 vocab=50304; alternating
sLSTM + mLSTM blocks. [arXiv:2405.04517]"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv=4,
    d_ff=0,
    vocab=50304,
    cycle=("slstm", "mlstm"),
    lstm_proj_factor=2.0,
)
