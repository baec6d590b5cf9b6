"""qwen2-7b [dense] — Qwen2 Technical Report
[arXiv:2407.10671; hf Qwen/Qwen2-7B].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, QKV bias.
28 heads is not divisible by the 16-way model axis -> attention runs with
sequence sharding (SP) instead of head sharding (see shardings.py).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab=152064, qkv_bias=True,
    remat_policy="none", train_microbatch=4, fsdp=True,
)
