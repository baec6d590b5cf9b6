"""internvl2-2b [vlm] — InternVL2 [arXiv:2404.16821; hf OpenGVLab/InternVL2-2B].

InternLM2-1.8B backbone: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  The InternViT-300M vision tower is a STUB — input_specs()
provides precomputed patch embeddings (B, 256, d_model) prepended to the
text tokens.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, frontend="vision", n_patches=256,
    remat_policy="none", train_microbatch=2,
)
