# Copied from src/repro/configs/qwen2_moe_a2p7b.py (the port keeps its own copy).
"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts
(shared expert = one dense FFN of width 4*1408). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab_size=151_936, n_experts=60, top_k=4, n_shared_experts=4,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",  # mixed precision: bf16 params + f32 adam moments
                              # halve ZeRO weight-gather & grad-reduce bytes (EXPERIMENTS §Perf)
)
