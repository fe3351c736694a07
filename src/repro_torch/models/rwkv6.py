"""RWKV-6 "Finch" blocks: attention-free time-mix with data-dependent decay,
chunked-parallel for train/prefill and O(1)-state recurrent for decode —
port of ``src/repro/models/rwkv6.py``.

Recurrence per head (state S in R^{dk x dv}):
    out_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with per-channel decay w_t = exp(-exp(lw_t)) computed from the token-shifted
input through a LoRA.  The chunked form factorizes the decay products with
exponent clamping (|log| <= 30), exact because the per-step log decay is
floored at -30 / CHUNK.  The reference scans the chunk states; the port
loops over the chunks in Python.  Its three- and four-operand einsums are
written as pairwise products here.

The decode functions write the layer's rows of the state dict IN PLACE and
return the same dict (the reference returns an updated copy).  The shift
states are bfloat16 whatever the compute dtype, so each decode step rounds
the carried x to bfloat16, as the reference does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import register_params

CHUNK = 32
LORA = 64
CLAMP = 30.0
# Per-step log-decay floor: keeps |in-chunk cumulative decay| <= CLAMP so the
# rq/kq factorization is exact (no clipping ever binds), applied identically
# in the recurrent decode path.
LOGW_FLOOR = -CLAMP / CHUNK


def rwkv_param_specs(cfg: ModelConfig) -> dict:
    """name -> (shape, logical_axes)."""
    d = cfg.d_model
    vec = ((d,), (None,))
    return {
        # time-mix
        "mix_r": vec, "mix_k": vec, "mix_v": vec, "mix_w": vec, "mix_g": vec,
        "wr": ((d, d), ("embed", "heads")), "wk": ((d, d), ("embed", "heads")),
        "wv": ((d, d), ("embed", "heads")), "wg": ((d, d), ("embed", "heads")),
        "wo": ((d, d), ("heads", "embed")),
        "w_lora_a": ((d, LORA), ("embed", None)),
        "w_lora_b": ((LORA, d), (None, None)),
        "w_base": vec,
        "u": vec,                      # per-channel bonus
        "ln_x": vec,
        # channel-mix
        "cmix_k": vec, "cmix_r": vec,
        "ck": ((d, cfg.d_ff), ("embed", "mlp")),
        "cv": ((cfg.d_ff, d), ("mlp", "embed")),
        "cr": ((d, d), ("embed", "heads")),
    }


class RWKV(torch.nn.Module):
    """The time-mix and channel-mix parameters of one rwkv layer (the
    reference's ``tm`` subtree), matrices in (in, out) orientation."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        register_params(self, rwkv_param_specs(cfg), dtype, device)


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Token shift: x_{t-1} (zeros / carried state at t=0). x (B,S,D)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _mix(x, xs, m):
    return x + (xs - x) * m.to(x.dtype)


def _time_mix_inputs(cfg: ModelConfig, p: RWKV, x: torch.Tensor,
                     xs: torch.Tensor):
    h, dk = cfg.n_heads, cfg.d_model // cfg.n_heads
    B, S, D = x.shape
    r = (_mix(x, xs, p.mix_r) @ p.wr.to(x.dtype)).reshape(B, S, h, dk)
    k = (_mix(x, xs, p.mix_k) @ p.wk.to(x.dtype)).reshape(B, S, h, dk)
    v = (_mix(x, xs, p.mix_v) @ p.wv.to(x.dtype)).reshape(B, S, h, dk)
    g = F.silu(_mix(x, xs, p.mix_g) @ p.wg.to(x.dtype))
    xw = _mix(x, xs, p.mix_w)
    lw = p.w_base.float() + (torch.tanh(xw @ p.w_lora_a.to(x.dtype)).float()
                             @ p.w_lora_b.float())
    logw = torch.clamp_min(-torch.exp(lw), LOGW_FLOOR)   # log decay in
    logw = logw.reshape(B, S, h, dk)                     # [LOGW_FLOOR, 0]
    u = p.u.float().reshape(h, dk)
    return r, k, v, g, logw, u


def _ln_x(cfg: ModelConfig, p: RWKV, y: torch.Tensor) -> torch.Tensor:
    """Group norm over heads of y (B,S,D) float32, scaled by 1 + ln_x."""
    B, S, D = y.shape
    h = cfg.n_heads
    yf = y.reshape(B, S, h, D // h)
    yf = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + cfg.norm_eps)
    return yf.reshape(B, S, D) * (1 + p.ln_x.float())


def time_mix(cfg: ModelConfig, p: RWKV, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence chunked WKV6. x (B,S,D) -> (B,S,D).  Raises
    ``ValueError`` unless S is a multiple of min(CHUNK, S), where the
    reference's assert fails."""
    B, S, D = x.shape
    h, dk = cfg.n_heads, D // cfg.n_heads
    r, k, v, g, logw, u = _time_mix_inputs(cfg, p, x, _shift(x))
    L = min(CHUNK, S)
    nc = S // L
    if S % L:
        raise ValueError(f"seq {S} must be a multiple of chunk {L}")
    rf = r.float().reshape(B, nc, L, h, dk)
    kf = k.float().reshape(B, nc, L, h, dk)
    vf = v.float().reshape(B, nc, L, h, dk)
    lw = logw.reshape(B, nc, L, h, dk)
    cw = torch.cumsum(lw, dim=2)                          # (B,nc,L,h,dk)
    cw_prev = cw - lw                                     # cumsum up to t-1
    rq = rf * torch.exp(torch.clamp(cw_prev, -CLAMP, CLAMP))
    kq = kf * torch.exp(torch.clamp(-cw, -CLAMP, CLAMP))
    A = torch.einsum("bclhd,bcshd->bchls", rq, kq)        # (B,nc,h,L,L)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device),
                     -1)                                  # strict lower
    A = A.masked_fill_(~tri, 0.0)
    y_intra = torch.einsum("bchls,bcshd->bclhd", A, vf)
    del A
    # diagonal bonus: sum_d r u k, times v
    y_intra = y_intra + (rf * u * kf).sum(-1, keepdim=True) * vf

    # inter-chunk state scan
    decay_all = torch.exp(torch.clamp(cw[:, :, -1], -CLAMP, CLAMP))  # (B,nc,h,dk)
    k_tail = kf * torch.exp(torch.clamp(cw[:, :, -1:] - cw, -CLAMP, CLAMP))
    contrib = torch.einsum("bclhd,bclhe->bchde", k_tail, vf)         # (B,nc,h,dk,dv)
    states = torch.empty_like(contrib)                   # state before chunk c
    s = torch.zeros((B, h, dk, dk), dtype=torch.float32, device=x.device)
    for c in range(nc):
        states[:, c] = s
        s = s * decay_all[:, c, ..., None] + contrib[:, c]
    del contrib
    y_inter = torch.einsum("bclhd,bchde->bclhe", rq, states)
    y = _ln_x(cfg, p, (y_intra + y_inter).reshape(B, S, D))
    return (y.to(x.dtype) * g) @ p.wo.to(x.dtype)


def channel_mix(cfg: ModelConfig, p: RWKV, x: torch.Tensor) -> torch.Tensor:
    xs = _shift(x)
    k = _mix(x, xs, p.cmix_k) @ p.ck.to(x.dtype)
    kv = torch.square(F.relu(k)) @ p.cv.to(x.dtype)
    rg = torch.sigmoid(_mix(x, xs, p.cmix_r) @ p.cr.to(x.dtype))
    return rg * kv


def rwkv_state_specs(cfg: ModelConfig, batch: int, n_layers: int) -> dict:
    h, dk = cfg.n_heads, cfg.d_model // cfg.n_heads
    return {
        "wkv": ((n_layers, batch, h, dk, dk), "float32"),
        "tshift_t": ((n_layers, batch, cfg.d_model), "bfloat16"),  # time-mix x_{t-1}
        "tshift_c": ((n_layers, batch, cfg.d_model), "bfloat16"),  # channel-mix
    }


def rwkv_decode(cfg: ModelConfig, p: RWKV, x: torch.Tensor, state: dict,
                layer: int) -> tuple[torch.Tensor, dict]:
    """One-token recurrent time-mix step. x (B,1,D); writes the layer's
    ``wkv`` and ``tshift_t`` rows of ``state`` in place.  The caller handles
    the residual/norm wiring."""
    B, _, D = x.shape
    prev_t = state["tshift_t"][layer][:, None].to(x.dtype)
    r, k, v, g, logw, u = _time_mix_inputs(cfg, p, x, prev_t)
    rf = r.float()[:, 0]
    kf = k.float()[:, 0]
    vf = v.float()[:, 0]
    w = torch.exp(logw.float())[:, 0]                             # (B,h,dk)
    S = state["wkv"][layer]                                       # (B,h,dk,dv)
    out = torch.einsum("bhd,bhde->bhe", rf, S) \
        + (rf * u * kf).sum(-1, keepdim=True) * vf
    S = S * w[..., None] + kf[..., :, None] * vf[..., None, :]
    y = _ln_x(cfg, p, out.reshape(B, 1, D))
    y = (y.to(x.dtype) * g) @ p.wo.to(x.dtype)
    state["wkv"][layer] = S
    state["tshift_t"][layer] = x[:, 0].to(state["tshift_t"].dtype)
    return y, state


def rwkv_channel_decode(cfg: ModelConfig, p: RWKV, x: torch.Tensor,
                        state: dict, layer: int) -> tuple[torch.Tensor, dict]:
    """One-token channel-mix step; writes the layer's ``tshift_c`` row of
    ``state`` in place."""
    prev = state["tshift_c"][layer][:, None].to(x.dtype)
    k = _mix(x, prev, p.cmix_k) @ p.ck.to(x.dtype)
    kv = torch.square(F.relu(k)) @ p.cv.to(x.dtype)
    rg = torch.sigmoid(_mix(x, prev, p.cmix_r) @ p.cr.to(x.dtype))
    state["tshift_c"][layer] = x[:, 0].to(state["tshift_c"].dtype)
    return rg * kv, state
