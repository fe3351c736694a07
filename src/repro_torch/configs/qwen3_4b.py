# Copied from src/repro/configs/qwen3_4b.py (the port keeps its own copy).
"""qwen3-4b [dense]: GQA kv=8, qk_norm, head_dim 128. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=9728,
    vocab_size=151_936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
)
