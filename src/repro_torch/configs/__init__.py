"""Assigned-architecture configs (--arch <id> resolves here)."""
from .base import SHAPES, ModelConfig, ShapeSpec, shape_for

from . import (codeqwen15_7b, internlm2_1_8b, musicgen_large, paligemma_3b,
               qwen3_14b, qwen3_32b, qwen3_moe_30b_a3b, qwen3_moe_235b_a22b,
               rwkv6_3b, zamba2_2_7b)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen3_14b, codeqwen15_7b, qwen3_32b, internlm2_1_8b, rwkv6_3b,
              zamba2_2_7b, qwen3_moe_30b_a3b, qwen3_moe_235b_a22b,
              musicgen_large, paligemma_3b)
}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    try:
        return ARCHS[name]
    except KeyError as e:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(ARCHS)}") from e


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get_config",
           "shape_for"]
