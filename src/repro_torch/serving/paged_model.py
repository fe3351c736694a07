"""Paged decode step: the dense-family decode path with the KV cache in a
global page pool addressed through the learned page table — port of
``src/repro/serving/paged_model.py``.

The pool is one device-resident (L, P, page, Hkv, Dh) float32 tensor each
for k and v; each layer's attention (K6 ``paged_attention``) reads a view
of its layer, with no copy (the reference uploads each layer's pool afresh
at every layer of every step).  The whole step computes in float32, as the
reference's does; the port leaves TF32 off, so its matrix products are full
float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels.paged_attention.ops import paged_attention
from ..models.attention import _project_qkv
from ..models.common import apply_rope, rms_norm
from ..models.mlp import mlp
from ..models.model import DenseLM, _head


def init_page_pool(cfg: ModelConfig, n_pages: int, page_size: int,
                   device) -> dict:
    hk, dh = cfg.n_kv_heads, cfg.head_dim_
    shape = (cfg.n_layers, n_pages, page_size, hk, dh)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=device),
            "v": torch.zeros(shape, dtype=torch.float32, device=device)}


def _last_writer(flat: torch.Tensor) -> torch.Tensor:
    """For each row, the highest row writing the same pool entry: every
    duplicate then writes the same values, so the scatter is deterministic
    and equals the reference's numpy assignment (the last row wins)."""
    B = flat.shape[0]
    rows = torch.arange(B, device=flat.device)
    same = flat[:, None] == flat[None, :]
    return torch.where(same, rows[None, :], -1).amax(1)


@torch.inference_mode()
def paged_decode_step(cfg: ModelConfig, model: DenseLM, tokens, pos,
                      pool: dict, tables: torch.Tensor, page_size: int, *,
                      trace: list | None = None):
    """One decode step for a dense-family config.

    tokens (B, 1) integer; pos (B,) integer positions on the host (numpy);
    tables (B, NP) int32 physical page per logical page on the pool's
    device (from ``LearnedPageTable.translate_batch``).  Writes the new
    token's k/v into ``pool`` in place.  Returns (logits (B, V) float32,
    next_token (B,) int32), on the pool's device.

    A position whose page index ``pos // page_size`` falls outside the
    table raises ``IndexError`` on the host before anything is written, as
    the reference's numpy indexing does.  With ``trace`` (a list), each K6
    call is appended as ``(inputs, output)``."""
    dev = pool["k"].device
    pos = np.asarray(pos, dtype=np.int64)
    B, NP = tables.shape
    lp = pos // page_size
    bad = (lp < -NP) | (lp >= NP)
    if bad.any():
        i = int(np.argmax(bad))
        raise IndexError(f"index {int(lp[i])} is out of bounds for axis 1 "
                         f"with size {NP}")
    tok = torch.as_tensor(np.asarray(tokens), device=dev).long()
    x = model.embed[tok].float()
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    pos_t = torch.from_numpy(pos).to(dev)
    lengths = (pos_t + 1).to(torch.int32)
    bidx = torch.arange(B, device=dev)
    phys = tables[bidx, torch.from_numpy(lp).to(dev)].long()
    slot = pos_t % page_size
    # (page, slot) as one index into a layer's (P * page, Hkv, Dh) rows
    flat = phys * page_size + slot
    src = _last_writer(flat)
    P, page, hk, dh = pool["k"].shape[1:]

    for layer, p in enumerate(model.layers):
        h_in = rms_norm(x, p.ln1, cfg.norm_eps)
        q, k, v = _project_qkv(cfg, p.attn, h_in)
        q = apply_rope(q, pos_t[:, None], cfg.rope_theta)
        k = apply_rope(k, pos_t[:, None], cfg.rope_theta)
        # write the new token's k/v into its learned-index-addressed page
        pool["k"][layer].view(P * page, hk, dh)[flat] = k[src, 0].float()
        pool["v"][layer].view(P * page, hk, dh)[flat] = v[src, 0].float()
        args = (tables, lengths, q[:, 0].contiguous(), pool["k"][layer],
                pool["v"][layer])
        att = paged_attention(*args)
        if trace is not None:
            trace.append((args, att))
        a = att.reshape(B, 1, -1) @ p.attn.wo.to(x.dtype)
        if cfg.post_norm:
            a = rms_norm(a, p.ln1_post, cfg.norm_eps)
        x = x + a
        hh = rms_norm(x, p.ln2, cfg.norm_eps)
        ff = mlp(cfg, p.ffn, hh)
        if cfg.post_norm:
            ff = rms_norm(ff, p.ln2_post, cfg.norm_eps)
        x = x + ff

    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head(cfg, model, x)[:, 0]
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, nxt
