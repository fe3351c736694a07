# Copied from src/repro/configs/qwen3_8b.py (the port keeps its own copy).
"""qwen3-8b [dense]: GQA kv=8, qk_norm, head_dim 128. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12_288,
    vocab_size=151_936, head_dim=128, qk_norm=True, rope_theta=1_000_000.0,
)
