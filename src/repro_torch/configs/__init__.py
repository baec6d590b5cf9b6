"""Assigned-architecture registry: ``--arch <id>`` resolves here."""
from .base import (ArchConfig, ShapeConfig, SHAPES, TensorSpec, input_specs,
                   shapes_for, smoke)
from . import (deepseek_moe_16b, internlm2_1_8b, internvl2_2b,
               musicgen_large, olmoe_1b_7b, qwen1_5_110b, qwen2_7b,
               tinyllama_1_1b, xlstm_125m, zamba2_2_7b)

ARCHS = {m.CONFIG.name: m.CONFIG for m in (
    olmoe_1b_7b, deepseek_moe_16b, tinyllama_1_1b, qwen1_5_110b,
    internlm2_1_8b, qwen2_7b, musicgen_large, zamba2_2_7b, internvl2_2b,
    xlstm_125m)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_arch", "ArchConfig", "ShapeConfig", "SHAPES",
           "TensorSpec", "input_specs", "shapes_for", "smoke"]
