"""Attention: GQA with qk-norm / bias / softcap / sliding window /
cross-attention, over the whole sequence (train/prefill), for one new token
against a contiguous KV cache (decode), and against frontend-stub memory
(cross) — port of ``src/repro/models/attention.py``.  The paged decode path
(``serving.paged_model``) attends through the K6 kernel instead and uses
only the projection.

The reference's sharding hooks are dropped: its ``shard_acts`` calls
(``parallel.sharding.shard_acts`` is ported as the identity: there is no
GSPMD layout to constrain) and the ``attn_seq_shard`` branch (q rows kept
on their seq shard).  ``kv_cache_specs`` gives (shape, dtype); the cache's
logical axes (the reference's ``CACHE_AXES`` and ``SCALE_AXES``) live in
``models.model``, whose ``input_specs`` attaches them.  The reference
scans the query chunks of a long sequence; the port loops over them in
Python.

The cache is updated IN PLACE (the reference updates it functionally and
returns the new dict; the port returns the same dict).  Shapes:
  x            (B, S, D)
  cache k/v    (A, B, S_max, Hkv, Dh)  [+ scales (A, B, S_max, Hkv) when int8]
where A is the number of attention layers.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ModelConfig
from .common import apply_rope, register_params, rms_norm


def attn_param_specs(cfg: ModelConfig, cross: bool = False) -> dict:
    """name -> (shape, logical_axes); a cross-attention layer's are the
    same.  ``cross`` changes nothing: it is kept only so the signature is
    the reference's."""
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


def _sdpa(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """q (B,Sq,H,Dh), k/v (B,Sk,Hkv,Dh); GQA via head grouping.  The logits
    product is rounded to the compute dtype before its float32 cast, the
    softcap comes before the mask, and the softmax (float32) is cast to
    v's dtype before the second product, as in the reference.  With no
    gradient to keep, the scale, softcap, mask and softmax write over the
    logits (``out=``), so they are the one full-size float32 tensor alive:
    the vlm's 2 x 8192 prefill holds 17.2 GB of them beside 40.4 GB of
    weights.  Where autograd records the logits (``out=`` is not
    differentiable, and ``mul_`` would overwrite the output ``tanh``
    saves), the same steps run out of place."""
    h, hk, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    g = h // hk
    B, Sq = q.shape[0], q.shape[1]
    q = q.reshape(B, Sq, hk, g, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).float()
    if logits.requires_grad:
        logits = logits / math.sqrt(dh)
        if cfg.attn_softcap:
            logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
        if mask is not None:
            logits = logits.masked_fill(~mask, -1e30)
        w = torch.softmax(logits, dim=-1).to(v.dtype)
    else:
        # in place past the cast: the full-width logits are the largest
        # temporaries of a prefill
        logits.div_(math.sqrt(dh))
        if cfg.attn_softcap:
            logits.div_(cfg.attn_softcap).tanh_().mul_(cfg.attn_softcap)
        if mask is not None:
            logits.masked_fill_(~mask, -1e30)
        w = torch.softmax(logits, dim=-1, out=logits).to(v.dtype)
    del logits
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, h * dh)


def _q_chunk(cfg: ModelConfig, S: int) -> int:
    """Query-chunk size: 0 = no chunking."""
    if cfg.attn_q_chunk < 0:
        return 0
    if cfg.attn_q_chunk > 0:
        return min(cfg.attn_q_chunk, S)
    return S // 16 if S > 8192 else 0  # auto: bound logits to S^2/16


def _causal_mask(cfg: ModelConfig, rows: torch.Tensor, S: int,
                 sliding_flag) -> torch.Tensor:
    """(R, S) mask for global query-row indices ``rows``."""
    i = rows[:, None]
    j = torch.arange(S, dtype=rows.dtype, device=rows.device)[None, :]
    mask = j <= i
    if cfg.sliding_window and sliding_flag:
        mask = mask & (j > i - cfg.sliding_window)
    return mask


def full_attention(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                   positions: torch.Tensor, sliding_flag=False):
    """Causal self-attention over the whole sequence (train/prefill).

    Long sequences are processed in query chunks (``_q_chunk``): each
    chunk's rows get their complete softmax over the full key prefix, so
    chunking is exact while the logits shrink from S^2 to chunk*S.
    Returns (out, k, v) so prefill can populate the KV cache."""
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    B, S = x.shape[0], x.shape[1]
    C = _q_chunk(cfg, S)
    if C == 0 or S % C != 0 or C >= S:
        C = S
    outs = []
    for off in range(0, S, C):
        rows = torch.arange(off, off + C, dtype=torch.int32, device=x.device)
        mask = _causal_mask(cfg, rows, S, sliding_flag)
        outs.append(_sdpa(cfg, q[:, off:off + C], k, v, mask))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out @ p.wo.to(x.dtype), k, v


def cross_attention(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                    memory: Optional[torch.Tensor] = None,
                    kv: Optional[tuple] = None) -> torch.Tensor:
    """Cross-attention against frontend-stub memory (B, P, D): no mask, no
    rope.  Either ``memory`` (k/v projected here: train/prefill) or the
    precomputed ``kv`` from the cross cache (decode)."""
    if kv is None:
        q, k, v = _project_qkv(cfg, p, x, kv_src=memory)
    else:
        h, dh = cfg.n_heads, cfg.head_dim_
        q = x @ p.wq.to(x.dtype)
        if cfg.qkv_bias:
            q = q + p.bq.to(x.dtype)
        q = q.reshape(*x.shape[:-1], h, dh)
        if cfg.qk_norm:
            q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k, v = kv
    out = _sdpa(cfg, q, k.to(x.dtype), v.to(x.dtype), None)
    return out @ p.wo.to(x.dtype)


def cross_kv(cfg: ModelConfig, p: Attention, memory: torch.Tensor):
    """The cross-attention k/v of one layer (prefill -> cache), each
    (B, P, Hkv, Dh) in memory's dtype."""
    hk, dh = cfg.n_kv_heads, cfg.head_dim_
    k = memory @ p.wk.to(memory.dtype)
    v = memory @ p.wv.to(memory.dtype)
    if cfg.qkv_bias:
        k = k + p.bk.to(memory.dtype)
        v = v + p.bv.to(memory.dtype)
    k = k.reshape(*memory.shape[:-1], hk, dh)
    v = v.reshape(*memory.shape[:-1], hk, dh)
    if cfg.qk_norm:
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


# ------------------------------------------------------------- KV cache utils

def kv_cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                   n_attn: int) -> dict:
    """name -> (shape, dtype) for one attention stack's cache."""
    hk, dh = cfg.n_kv_heads, cfg.head_dim_
    base = (n_attn, batch, s_max, hk, dh)
    if cfg.kv_cache_dtype == "int8":
        return {"k": (base, "int8"), "v": (base, "int8"),
                "k_scale": ((n_attn, batch, s_max, hk), "float32"),
                "v_scale": ((n_attn, batch, s_max, hk), "float32")}
    return {"k": (base, cfg.kv_cache_dtype), "v": (base, cfg.kv_cache_dtype)}


def _quant(x: torch.Tensor):
    """Symmetric int8 over the last axis; x (..., Dh) -> (q int8, scale f32).
    Both divisions are true divisions (the divisor is a tensor on x's
    device, so no kernel turns them into products by a reciprocal), and
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    d127 = torch.tensor(127.0, dtype=torch.float32, device=x.device)
    scale = xf.abs().amax(dim=-1) / d127 + 1e-8
    q = torch.round(xf / scale[..., None]).to(torch.int8)
    return q, scale


def write_cache_prefill(cfg: ModelConfig, cache: dict, layer: int, k,
                        v) -> dict:
    """Write a (B,S,Hk,Dh) prefill k/v at stacked-cache row ``layer``, in
    place.  The prompt may be shorter than the cache (S <= S_max)."""
    S = k.shape[1]
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quant(k)
        vq, vs = _quant(v)
        cache["k"][layer, :, :S] = kq
        cache["v"][layer, :, :S] = vq
        cache["k_scale"][layer, :, :S] = ks
        cache["v_scale"][layer, :, :S] = vs
    else:
        cache["k"][layer, :, :S] = k
        cache["v"][layer, :, :S] = v
    return cache


def decode_attention(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                     cache: dict, layer: int, pos: torch.Tensor,
                     sliding_flag=False):
    """One-token decode: write the cache at ``pos`` (in place) and attend
    over it.  x (B,1,D); cache tensors as in kv_cache_specs; pos (B,)
    integer on x's device.  Returns (out (B,1,D), cache)."""
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    B = x.shape[0]
    bidx = torch.arange(B, device=x.device)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quant(k)
        vq, vs = _quant(v)
        cache["k"][layer, bidx, pos] = kq[:, 0]
        cache["v"][layer, bidx, pos] = vq[:, 0]
        cache["k_scale"][layer, bidx, pos] = ks[:, 0]
        cache["v_scale"][layer, bidx, pos] = vs[:, 0]
        kf = (cache["k"][layer].float()
              * cache["k_scale"][layer][..., None]).to(x.dtype)
        vf = (cache["v"][layer].float()
              * cache["v_scale"][layer][..., None]).to(x.dtype)
    else:
        cache["k"][layer, bidx, pos] = k[:, 0].to(cache["k"].dtype)
        cache["v"][layer, bidx, pos] = v[:, 0].to(cache["v"].dtype)
        kf = cache["k"][layer].to(x.dtype)
        vf = cache["v"][layer].to(x.dtype)
    S = kf.shape[1]
    j = torch.arange(S, device=x.device)[None, :]
    mask = j <= pos[:, None]
    if cfg.sliding_window and sliding_flag:
        mask = mask & (j > pos[:, None] - cfg.sliding_window)
    out = _sdpa(cfg, q, kf, vf, mask[:, None, None, None, :])
    return out @ p.wo.to(x.dtype), cache
