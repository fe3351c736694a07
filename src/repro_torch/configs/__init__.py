"""Architecture registry of the port: the configs its serving path runs.

Port of ``src/repro/configs/__init__.py`` over the dense family (qwen3-4b,
qwen3-8b, gemma2-9b, qwen1.5-32b) and the moe family (granite-moe-1b-a400m,
qwen2-moe-a2.7b); the other four configs come with their families (ROADMAP
Queue 1 item 9.5).  ``get_config(name)`` raises ``KeyError`` for an
unknown id, as the reference does.
"""
from .base import LONG_CONTEXT_ARCHS, SHAPES, ModelConfig, ShapeConfig, shapes_for
from . import (gemma2_9b, granite_moe_1b, qwen1p5_32b, qwen2_moe_a2p7b,
               qwen3_4b, qwen3_8b)

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        qwen3_4b.CONFIG, gemma2_9b.CONFIG, qwen3_8b.CONFIG, qwen1p5_32b.CONFIG,
        granite_moe_1b.CONFIG, qwen2_moe_a2p7b.CONFIG,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "shapes_for", "LONG_CONTEXT_ARCHS"]
