"""Architecture config schema + assigned input shapes.

One ``<arch>.py`` per assigned architecture defines ``CONFIG`` with the
exact published numbers (source cited in its docstring) and a reduced
``smoke()`` variant for CPU tests.  ``input_specs`` describes every model
input as a ``TensorSpec`` (shape and torch dtype) without allocating it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of a model input, with no storage behind it."""
    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "swiglu"          # swiglu | gelu
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid (zamba2-style: shared attn block every `attn_every`)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0
    # xLSTM: indices of sLSTM layers (others are mLSTM)
    slstm_at: tuple[int, ...] = ()
    # modality frontend stub: none | vision | audio
    frontend: str = "none"
    n_patches: int = 256
    # capabilities
    sub_quadratic: bool = False  # may run long_500k
    fsdp: bool = False           # ZeRO-3 weight sharding over 'data'
    # MoE dispatch implementation: 'gather' (shard_map EP, zero dispatch
    # FLOPs — production default) | 'onehot' (GShard-style einsum dispatch,
    # kept as the reference/baseline for §Perf comparisons)
    moe_impl: str = "gather"
    remat: bool = True
    # remat policy for scanned layer bodies: 'dots' saves projection
    # outputs (fastest backward, highest memory); 'none' saves only scan
    # carries (recompute-everything, fits the big archs)
    remat_policy: str = "dots"
    # gradient-accumulation microbatches for train_4k (activation memory
    # divides by this; chosen so peak/device fits 16 GB HBM)
    train_microbatch: int = 1
    # int8 KV-cache quantization (per token x head scales): halves decode
    # cache footprint; enabled where the bf16 cache would bust HBM
    kv_quant: bool = False
    # AdamW moment storage dtype ('bf16' compresses optimizer state 2x on
    # the 100B-class archs)
    opt_moments: str = "f32"

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def params_count(self) -> int:
        """Total parameter count (for 6ND model-FLOPs accounting)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        n = 2 * V * d                      # embed + unembed
        n += d                             # final norm
        if self.family == "ssm":           # xLSTM
            for i in range(L):
                if i in self.slstm_at:
                    n += 4 * 2 * d * d + 2 * d   # slstm: i,f,z,o x (Wx+Wh)
                else:
                    n += 2 * d * 2 * d + 2 * d * d + 4 * d  # mlstm qkv+up/out
            return n
        per_attn = (d * self.n_heads * self.dh              # wq
                    + 2 * d * self.n_kv_heads * self.dh     # wk, wv
                    + self.n_heads * self.dh * d)           # wo
        per_mlp_d = (3 if self.act == "swiglu" else 2) * d * self.d_ff
        if self.family == "moe":
            per_ffn = (self.n_experts *
                       (3 if self.act == "swiglu" else 2) * d * self.moe_d_ff
                       + d * self.n_experts)
            per_ffn += (self.n_shared_experts *
                        (3 if self.act == "swiglu" else 2) * d * self.moe_d_ff)
            n += L * (per_attn + per_ffn + 2 * d)
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.n_ssm_heads
            per_mamba = (d * (2 * di + 2 * N + H)  # in_proj (z,x,B,C,dt)
                         + 4 * di                   # conv
                         + di * d + 2 * H + d)      # out_proj, A/D, norm
            n += L * per_mamba
            n_attn_blocks = 1  # shared block (weight tying!)
            n += n_attn_blocks * (per_attn + per_mlp_d + 2 * d)
        else:
            n += L * (per_attn + per_mlp_d + 2 * d)
        return n

    def active_params_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.family != "moe":
            return self.params_count()
        d, L = self.d_model, self.n_layers
        dense = self.params_count()
        per_expert = (3 if self.act == "swiglu" else 2) * d * self.moe_d_ff
        inactive = L * (self.n_experts - self.top_k) * per_expert
        return dense - inactive


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ArchConfig) -> list[str]:
    """Live cells per arch: long_500k only for sub-quadratic archs
    (DESIGN.md §5 records the skips)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """TensorSpec stand-ins for every model input: no allocation.
    Modality frontends are STUBS — the vision tower / EnCodec encoder is
    replaced by precomputed embeddings."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if shape.kind == "train":
        spec = {"tokens": TensorSpec((B, S), i32),
                "labels": TensorSpec((B, S), i32)}
        if cfg.frontend == "vision":
            spec["patch_embeds"] = TensorSpec(
                (B, cfg.n_patches, cfg.d_model), bf16)
            spec["tokens"] = TensorSpec((B, S - cfg.n_patches), i32)
            spec["labels"] = TensorSpec((B, S - cfg.n_patches), i32)
        return spec
    if shape.kind == "prefill":
        spec = {"tokens": TensorSpec((B, S), i32)}
        if cfg.frontend == "vision":
            spec["patch_embeds"] = TensorSpec(
                (B, cfg.n_patches, cfg.d_model), bf16)
            spec["tokens"] = TensorSpec((B, S - cfg.n_patches), i32)
        return spec
    # decode: one new token against a cache/state of length S
    return {"tokens": TensorSpec((B, 1), i32),
            "pos": TensorSpec((B,), i32)}


def smoke(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests (small layers/width,
    few experts, tiny vocab)."""
    smoke_attn_every = min(cfg.attn_every, 2) if cfg.attn_every else 0
    return replace(
        cfg,
        n_layers=max(2, min(4, cfg.n_layers // 8)) if smoke_attn_every == 0
        else 2 * smoke_attn_every,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab=512,
        n_experts=8 if cfg.n_experts else 0,
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else 64,
        attn_every=smoke_attn_every,
        slstm_at=tuple(i for i in cfg.slstm_at if i < 4)[:2]
        if cfg.slstm_at else (),
        n_patches=16 if cfg.frontend == "vision" else cfg.n_patches,
        fsdp=False,
        train_microbatch=1,
    )
