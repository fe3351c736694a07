# Copied from src/repro/configs/musicgen_medium.py (the port keeps its own copy).
"""musicgen-medium [audio]: decoder-only over EnCodec tokens; the EnCodec
frontend is a STUB — input_specs() provides precomputed frame embeddings
(DESIGN.md §6). [arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab_size=2048, act="gelu", frontend_stub=True, rope_theta=10_000.0,
)
