"""olmoe-1b-7b [moe] — OLMoE: Open Mixture-of-Experts Language Models
[arXiv:2409.02060; hf allenai/OLMoE-1B-7B-0924].

16L d_model=2048 16H (GQA kv=16) per-expert d_ff=1024 vocab=50304,
MoE 64 experts top-8, SwiGLU, RoPE.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    n_experts=64, top_k=8, moe_d_ff=1024, remat_policy="none", train_microbatch=2,
)
