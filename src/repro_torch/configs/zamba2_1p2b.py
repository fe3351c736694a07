# Copied from src/repro/configs/zamba2_1p2b.py (the port keeps its own copy).
"""zamba2-1.2b [hybrid]: Mamba2 backbone + one shared attention block applied
every 6 SSM layers (weights reused). [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=32_000, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    shared_attn_period=6, rope_theta=10_000.0,
)
