# Copied from src/repro/configs/gemma2_9b.py (the port keeps its own copy).
"""gemma2-9b [dense]: local+global alternating attention, logit/attn softcaps.
[arXiv:2408.00118; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, d_ff=14_336,
    vocab_size=256_000, head_dim=256, sliding_window=4096,
    local_global_period=2, attn_softcap=50.0, logit_softcap=30.0,
    act="gelu", rope_theta=10_000.0, post_norm=True, embed_scale=True,
    kv_cache_dtype="int8",  # decode_32k: halve KV bytes; fits 16GB HBM (§Perf cell 3)
)
