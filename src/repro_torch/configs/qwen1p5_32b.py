# Copied from src/repro/configs/qwen1p5_32b.py (the port keeps its own copy).
"""qwen1.5-32b [dense]: MHA-style GQA kv=40, QKV bias. int8 KV cache for the
decode_32k cell (5.5 TB bf16 cache would exceed per-chip HBM at 256 chips —
DESIGN.md §6). [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27_392,
    vocab_size=152_064, qkv_bias=True, rope_theta=1_000_000.0,
    kv_cache_dtype="int8", attn_seq_shard=True,
    param_dtype="bfloat16",  # mixed precision: bf16 params + f32 adam moments
                              # halve ZeRO weight-gather & grad-reduce bytes (EXPERIMENTS §Perf)
)
