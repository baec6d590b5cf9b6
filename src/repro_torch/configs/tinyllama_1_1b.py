"""tinyllama-1.1b [dense] — TinyLlama: An Open-Source Small Language Model
[arXiv:2401.02385; hf TinyLlama/TinyLlama-1.1B].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000 (llama2 arch).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000, remat_policy="none", train_microbatch=2,
)
