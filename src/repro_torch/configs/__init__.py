"""Architecture registry of the port: the configs its serving path runs.

Port of ``src/repro/configs/__init__.py`` over the dense family only
(qwen3-4b, qwen3-8b); the other eight configs come with their families
(ROADMAP Queue 1 item 9).  ``get_config(name)`` raises ``KeyError`` for an
unknown id, as the reference does.
"""
from .base import LONG_CONTEXT_ARCHS, SHAPES, ModelConfig, ShapeConfig, shapes_for
from . import qwen3_4b, qwen3_8b

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [qwen3_4b.CONFIG, qwen3_8b.CONFIG]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "shapes_for", "LONG_CONTEXT_ARCHS"]
