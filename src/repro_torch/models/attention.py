"""Attention parameters and the q/k/v projection — port of
``src/repro/models/attention.py:28-63``.

The paged decode path (``serving.paged_model``) attends through the K6
kernel, so only the projection is needed here.  The contiguous-cache paths
(``_sdpa``, ``full_attention``, ``decode_attention``, the int8 cache) come
later (ROADMAP Queue 1 item 9).  The reference's sharding hook
(``shard_acts``) is the identity on one device and is dropped.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .common import register_params, rms_norm


def attn_param_specs(cfg: ModelConfig) -> dict:
    """name -> (shape, logical_axes)."""
    d, h, hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    p = {
        "wq": ((d, h * dh), ("embed", "heads")),
        "wk": ((d, hk * dh), ("embed", "kv_heads")),
        "wv": ((d, hk * dh), ("embed", "kv_heads")),
        "wo": ((h * dh, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p.update({"bq": ((h * dh,), ("heads",)),
                  "bk": ((hk * dh,), ("kv_heads",)),
                  "bv": ((hk * dh,), ("kv_heads",))})
    if cfg.qk_norm:
        p.update({"q_norm": ((dh,), (None,)), "k_norm": ((dh,), (None,))})
    return p


class Attention(torch.nn.Module):
    """``wq wk wv wo`` in (in, out) orientation, plus ``bq bk bv`` and/or
    ``q_norm k_norm`` as the config asks."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        register_params(self, attn_param_specs(cfg), dtype, device)


def _project_qkv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                 kv_src: Optional[torch.Tensor] = None):
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    src = x if kv_src is None else kv_src
    q = x @ p.wq.to(x.dtype)
    k = src @ p.wk.to(x.dtype)
    v = src @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(*x.shape[:-1], h, dh)
    k = k.reshape(*src.shape[:-1], hk, dh)
    v = v.reshape(*src.shape[:-1], hk, dh)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return q, k, v
