# Copied from src/repro/configs/base.py (the port keeps its own copy).
"""Model configuration dataclasses for the architecture zoo.

One config per assigned architecture (``src/repro/configs/<id>.py``) plus the
paper's own index config. ``reduced()`` yields the small-family variant used
by the per-arch CPU smoke tests; full configs are exercised only through the
AOT dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    logit_softcap: float = 0.0        # gemma2 final-logit softcap
    attn_softcap: float = 0.0         # gemma2 attention softcap
    sliding_window: int = 0           # gemma2 local layers
    local_global_period: int = 0      # gemma2: every 2nd layer is global
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / rwkv6)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # hybrid (zamba2): one shared attention block applied every N ssm layers
    shared_attn_period: int = 0
    # VLM: one cross-attention layer every N layers
    cross_attn_period: int = 0
    n_patches: int = 1601             # vision stub sequence length
    # modality frontends ([audio]/[vlm]) are stubs: inputs arrive as embeddings
    frontend_stub: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    post_norm: bool = False           # gemma2 post-sublayer norms
    embed_scale: bool = False         # gemma2 sqrt(d_model) embedding scale
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"  # int8 for the 32B decode config
    remat: bool = True
    use_pallas: bool = False          # jnp reference path by default (DESIGN §7)
    scan_unroll: bool = False         # dry-run cost probe: python-loop layers
                                      # (XLA cost analysis counts a while body
                                      # once; unrolling restores exact totals)
    attn_q_chunk: int = 0             # 0=auto (chunk long seqs), -1=never,
                                      # n=query-chunk rows. Exact (per-row
                                      # softmax is complete); bounds the S^2
                                      # logits materialization to chunk*S.
    attn_seq_shard: bool = False      # shard attention over Sq (q rows) with
                                      # k/v gathered in bf16 — for archs whose
                                      # head count doesn't divide the model
                                      # axis (qwen1.5: 40 heads vs 16), where
                                      # GSPMD otherwise all-to-alls f32 S^2
                                      # logits (§Perf cell 2).

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:         # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=min(self.n_layers, 4 if self.shared_attn_period == 0
                         else 2 * max(self.shared_attn_period, 1)),
            d_model=256, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads < self.n_heads else 4,
            d_ff=512, vocab_size=512, head_dim=64,
            n_experts=min(self.n_experts, 8), top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_patches=32, shared_attn_period=min(self.shared_attn_period, 2)
            if self.shared_attn_period else 0,
            cross_attn_period=min(self.cross_attn_period, 2)
            if self.cross_attn_period else 0,
            remat=False,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}

# long_500k needs a sub-quadratic path end-to-end: only SSM/hybrid archs
# qualify (DESIGN.md §6 documents the skips, incl. gemma2's global layers).
LONG_CONTEXT_ARCHS = {"zamba2-1.2b", "rwkv6-1.6b"}


def shapes_for(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.name in LONG_CONTEXT_ARCHS:
        out.append("long_500k")
    return out
