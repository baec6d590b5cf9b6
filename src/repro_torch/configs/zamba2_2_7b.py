"""zamba2-2.7b [hybrid] — Zamba2 suite [arXiv:2411.15242; hf Zyphra/Zamba2-2.7B].

54 Mamba2 layers d_model=2560 + ONE shared attention+MLP block (weights
tied) applied every 6 mamba layers; 32H (kv=32) d_ff=10240 for the shared
block; ssm_state=64, vocab=32000.  Sub-quadratic: runs long_500k.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=6,
    sub_quadratic=True, remat_policy="none", train_microbatch=2,
)
