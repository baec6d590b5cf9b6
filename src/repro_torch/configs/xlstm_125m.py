"""xlstm-125m [ssm] — xLSTM: Extended Long Short-Term Memory
[arXiv:2405.04517; config tier: unverified — 125M band model].

12L d_model=768 4H vocab=50304, d_ff=0 (no separate FFN; the mLSTM block
carries an internal up-projection).  sLSTM blocks at layers (0, 4, 8)
(xLSTM[7:1]-style sparse sLSTM placement), mLSTM elsewhere.
Recurrent state is O(1) in context -> runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, slstm_at=(0, 4, 8), sub_quadratic=True,
)
