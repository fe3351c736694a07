# Copied from src/repro/configs/llama32_vision_11b.py (the port keeps its own copy).
"""llama-3.2-vision-11b [vlm]: text backbone with cross-attention image layers
every 5 layers; the vision tower is a STUB — input_specs() provides
precomputed patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab_size=128_256, cross_attn_period=5, n_patches=1601,
    frontend_stub=True, rope_theta=500_000.0,
)
