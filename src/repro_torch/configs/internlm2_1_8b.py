"""internlm2-1.8b [dense] — InternLM2 Technical Report
[arXiv:2403.17297; hf internlm/internlm2-1_8b].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-1.8b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, remat_policy="none", train_microbatch=2,
)
