"""Mamba2 (SSD) blocks — chunkwise-parallel for train/prefill, recurrent for
decode; the zamba2 hybrid backbone's layers — port of
``src/repro/models/mamba2.py``.

Chunkwise SSD (Dao & Gu 2024): within a chunk, outputs are a masked
(decay-weighted) attention-like contraction; across chunks, a small
(H, N, Dh) state is carried.  The reference scans the chunk states; the
port loops over the chunks in Python.  Its three-operand einsums are
written as pairwise products here, and the (B, nc, L, L, H) intra-chunk
decay is built in place (one such tensor alive at a time).

``mamba_decode`` writes the layer's rows of the state dict IN PLACE and
returns the same dict (the reference returns an updated copy).  The conv
state is bfloat16 whatever the compute dtype, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import register_params

CHUNK = 256


def mamba_param_specs(cfg: ModelConfig) -> dict:
    """name -> (shape, logical_axes)."""
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    return {
        "in_proj": ((d, 2 * di + 2 * n + h), ("embed", None)),  # x, z, B, C, dt
        "conv_w": ((cfg.ssm_conv, di + 2 * n), (None, None)),   # depthwise conv
        "A_log": ((h,), (None,)),
        "D": ((h,), (None,)),
        "dt_bias": ((h,), (None,)),
        "out_proj": ((di, d), ("mlp", "embed")),
        "norm": ((di,), (None,)),
    }


class Mamba2(torch.nn.Module):
    """The parameters of one Mamba2 mixer (the reference's ``ssm``
    subtree), matrices in (in, out) orientation."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        register_params(self, mamba_param_specs(cfg), dtype, device)


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n = cfg.d_inner, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di: 2 * di]
    Bm = zxbcdt[..., 2 * di: 2 * di + n]
    Cm = zxbcdt[..., 2 * di + n: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    return z, x, Bm, Cm, dt


def _conv1d(x: torch.Tensor, w: torch.Tensor,
            state: Optional[torch.Tensor] = None):
    """Causal depthwise conv; x (B,S,C), w (K,C).  Returns (y, new_state).
    The K shifted products are summed in x's dtype, from Python's ``sum``
    (0 + t_0 + t_1 + ...), as in the reference."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * w[i][None, None].to(x.dtype)
            for i in range(K))
    return F.silu(y), xp[:, -(K - 1):]


def _gate_norm(cfg: ModelConfig, p: Mamba2, y: torch.Tensor, z: torch.Tensor,
               dt: torch.dtype) -> torch.Tensor:
    """y (..., d_inner) in ``dt`` times silu(z), RMS-normed (float32) and
    scaled by 1 + norm, back in ``dt``."""
    y = y * F.silu(z)
    yf = y.float()
    return (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True)
                             + cfg.norm_eps)
            * (1 + p.norm.float())).to(dt)


def mamba_block(cfg: ModelConfig, p: Mamba2, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD. u (B,S,D) -> (B,S,D).  Raises ``ValueError``
    unless S is a multiple of min(CHUNK, S), where the reference's assert
    fails."""
    B, S, _ = u.shape
    h, dh, n, di = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    z, x, Bm, Cm, dt = _split_proj(cfg, u @ p.in_proj.to(u.dtype))
    xbc, _ = _conv1d(torch.cat([x, Bm, Cm], dim=-1), p.conv_w)
    x, Bm, Cm = xbc[..., :di], xbc[..., di: di + n], xbc[..., di + n:]
    dt = F.softplus(dt.float() + p.dt_bias.float())                # (B,S,H)
    A = -torch.exp(p.A_log.float())                                 # (H,)
    x = x.reshape(B, S, h, dh)

    L = min(CHUNK, S)
    nc = S // L
    if S % L:
        raise ValueError(f"seq {S} must be a multiple of chunk {L}")
    xc = x.reshape(B, nc, L, h, dh).float()
    Bc = Bm.reshape(B, nc, L, n).float()
    Cc = Cm.reshape(B, nc, L, n).float()
    dtc = dt.reshape(B, nc, L, h)
    dA = dtc * A                                                    # (B,nc,L,H)
    cum = torch.cumsum(dA, dim=2)                                   # within-chunk

    # ---- intra-chunk (lower-triangular decay attention) -------------------
    # Ldec[t,s] = exp(cum[t]-cum[s]) for s<=t, built in place
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=u.device))
    M = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).exp_()      # (B,nc,L,L,H)
    M.masked_fill_(~tri[:, :, None], 0.0)
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)                     # (B,nc,L,L)
    M.mul_(G[..., None]).mul_(dtc[:, :, None, :, :])               # G * Ldec * dt
    y_intra = torch.einsum("bclsh,bcshd->bclhd", M, xc)
    del M, G

    # ---- inter-chunk state scan -------------------------------------------
    # state after chunk c: S_c = exp(sum dA) S_{c-1} + sum_s exp(cum_L-cum_s) dt_s B_s x_s
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,L,H)
    wx = xc * (dtc * decay_to_end)[..., None]                       # (B,nc,L,H,Dh)
    contrib = torch.einsum("bcsn,bcshd->bchnd", Bc, wx)             # (B,nc,H,N,Dh)
    del wx
    chunk_decay = torch.exp(cum[:, :, -1, :])                       # (B,nc,H)
    states = torch.empty_like(contrib)                              # prior state
    s = torch.zeros((B, h, n, dh), dtype=torch.float32, device=u.device)
    for c in range(nc):
        states[:, c] = s
        s = s * chunk_decay[:, c, :, None, None] + contrib[:, c]
    del contrib

    # ---- add inter-chunk contribution --------------------------------------
    decay_from_start = torch.exp(cum)                               # (B,nc,L,H)
    y_inter = torch.einsum("bcln,bchnd->bclhd", Cc, states) \
        * decay_from_start[..., None]
    y = (y_intra + y_inter).reshape(B, S, h, dh)
    y = y + x.float() * p.D.float()[None, None, :, None]
    y = _gate_norm(cfg, p, y.reshape(B, S, di).to(u.dtype), z, u.dtype)
    return y @ p.out_proj.to(u.dtype)


def mamba_state_specs(cfg: ModelConfig, batch: int, n_layers: int) -> dict:
    h, dh, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return {
        "ssm": ((n_layers, batch, h, n, dh), "float32"),
        "conv": ((n_layers, batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * n),
                 "bfloat16"),
    }


def mamba_decode(cfg: ModelConfig, p: Mamba2, u: torch.Tensor, state: dict,
                 layer: int) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step. u (B,1,D); writes the layer's ``ssm`` and
    ``conv`` rows of ``state`` in place."""
    B = u.shape[0]
    h, dh, n, di = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.d_inner
    z, x, Bm, Cm, dt = _split_proj(cfg, u @ p.in_proj.to(u.dtype))
    xbc = torch.cat([x, Bm, Cm], dim=-1)                            # (B,1,C)
    conv_st = state["conv"][layer].to(u.dtype)                      # (B,K-1,C)
    xbc_f, new_conv = _conv1d(xbc, p.conv_w, conv_st)
    x = xbc_f[..., :di].reshape(B, h, dh)
    Bm = xbc_f[..., di: di + n][:, 0]
    Cm = xbc_f[..., di + n:][:, 0]
    dt = F.softplus(dt.float() + p.dt_bias.float())[:, 0]          # (B,H)
    A = -torch.exp(p.A_log.float())
    dec = torch.exp(dt * A[None])                                   # (B,H)
    s = state["ssm"][layer]                                         # (B,H,N,Dh)
    s = s * dec[..., None, None] + (dt[:, :, None] * Bm.float()[:, None, :]
                                    )[..., None] * x.float()[:, :, None, :]
    y = torch.einsum("bn,bhnd->bhd", Cm.float(), s)
    y = y + x.float() * p.D.float()[None, :, None]
    y = _gate_norm(cfg, p, y.reshape(B, 1, di).to(u.dtype), z, u.dtype)
    out = y @ p.out_proj.to(u.dtype)
    state["ssm"][layer] = s
    state["conv"][layer] = new_conv.to(state["conv"].dtype)
    return out, state
