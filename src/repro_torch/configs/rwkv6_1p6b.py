# Copied from src/repro/configs/rwkv6_1p6b.py (the port keeps its own copy).
"""rwkv6-1.6b (Finch) [ssm]: attention-free, data-dependent decay WKV.
[arXiv:2404.05892; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab_size=65_536, ssm_head_dim=64,
)
