"""Architecture registry of the port — port of
``src/repro/configs/__init__.py``: the same ten configs, one module each
(the dense, moe, ssm, hybrid, audio and vlm families).

``get_config(name)`` resolves an architecture id (``--arch``) to its
ModelConfig and raises ``KeyError`` for an unknown id, as the reference
does.
"""
from .base import LONG_CONTEXT_ARCHS, SHAPES, ModelConfig, ShapeConfig, shapes_for
from . import (gemma2_9b, granite_moe_1b, llama32_vision_11b, musicgen_medium,
               qwen1p5_32b, qwen2_moe_a2p7b, qwen3_4b, qwen3_8b, rwkv6_1p6b,
               zamba2_1p2b)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        zamba2_1p2b.CONFIG, qwen3_4b.CONFIG, gemma2_9b.CONFIG, qwen3_8b.CONFIG,
        qwen1p5_32b.CONFIG, granite_moe_1b.CONFIG, qwen2_moe_a2p7b.CONFIG,
        rwkv6_1p6b.CONFIG, musicgen_medium.CONFIG, llama32_vision_11b.CONFIG,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "shapes_for", "LONG_CONTEXT_ARCHS"]
