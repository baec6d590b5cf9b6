"""qwen1.5-110b [dense] — Qwen1.5 series [hf Qwen/Qwen1.5-110B; config
family per hf:Qwen/Qwen1.5-0.5B scaled card].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
Largest assigned arch: FSDP (ZeRO-3) weight sharding over the data axis.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064, qkv_bias=True, fsdp=True,
    remat_policy="none", train_microbatch=8, kv_quant=True,
    opt_moments="bf16",
)
