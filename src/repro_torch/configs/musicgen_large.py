"""musicgen-large [audio] — Simple and Controllable Music Generation
[arXiv:2306.05284; hf facebook/musicgen-large].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 — decoder-only over
EnCodec tokens, GELU MLP.  The EnCodec frontend is a STUB: the backbone
consumes the token stream directly (single-codebook stream stands in for
the 4-codebook delay pattern; noted in DESIGN.md).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, act="gelu", frontend="audio",
    remat_policy="none", train_microbatch=4, kv_quant=True,
)
