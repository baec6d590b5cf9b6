"""deepseek-moe-16b [moe] — DeepSeekMoE: Towards Ultimate Expert
Specialization [arXiv:2401.06066; hf deepseek-ai/deepseek-moe-16b-base].

28L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=102400,
fine-grained MoE: 2 shared + 64 routed experts, top-6.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    remat_policy="none", train_microbatch=4, kv_quant=True, fsdp=True,
    opt_moments="bf16",
)
