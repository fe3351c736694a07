"""Shared layer primitives — port of ``src/repro/models/common.py``.

Explicit dtypes everywhere, as in the reference.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16, "int8": torch.int8}[name]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm scaled by ``1 + scale`` (the reference's convention: the
    scales start at 0), computed in float32 and cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap else x


def act_fn(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu}[name]


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=None)
def _inv_freqs(head_dim: int, theta: float, device: torch.device):
    # float64 in numpy, then float32, as the reference does
    return torch.from_numpy(rope_freqs(head_dim, theta).astype(np.float32)
                            ).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) integer."""
    d = x.shape[-1]
    inv = _inv_freqs(d, float(theta), x.device)
    ang = positions[..., None].float() * inv                   # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class _CotangentCast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def cotangent_cast(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; backward casts the cotangent to x's dtype, placed
    at the lm-head and embedding boundaries as in the reference.  (PyTorch
    already hands each tensor a gradient of its own dtype, so this keeps
    the reference's structure rather than changing a number.)"""
    return _CotangentCast.apply(x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  softcap_val: float = 0.0) -> torch.Tensor:
    """Mean next-token loss; logits (B,S,V) float32, labels (B,S) integer
    (-1 pad), the mean over the labels that are not padding."""
    logits = softcap(logits.float(), softcap_val)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.clamp(min=0).long()[..., None],
                              dim=-1)[..., 0]
    mask = labels >= 0
    nll = (lse - ll) * mask
    return nll.sum() / mask.sum().clamp(min=1)


def register_params(module: torch.nn.Module, specs: dict, dtype: torch.dtype,
                    device) -> None:
    """Give ``module`` one uninitialised parameter per entry of a
    ``name -> (shape, logical_axes)`` spec dict (``init_params`` or
    ``params_from_numpy`` fills them)."""
    for name, (shape, _) in specs.items():
        module.register_parameter(name, torch.nn.Parameter(
            torch.empty(shape, dtype=dtype, device=device),
            requires_grad=False))



def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise, how many bfloat16 steps lie between ``a`` and ``b``:
    the bit patterns read as integers in the order of their values (-0
    and +0 one value), so neighbours of either sign are 1 apart."""
    def order(t: torch.Tensor) -> torch.Tensor:
        x = t.cpu().contiguous().view(torch.int16).int()
        return torch.where(x < 0, -(x + 32768), x)
    return (order(a) - order(b)).abs()


def bf16_near(a: torch.Tensor, b: torch.Tensor, atol: float) -> bool:
    """Two bfloat16 tensors agree: each entry equal or one ulp apart, or
    within ``atol`` (the float32 value it rounds parted by that much).
    The rule the port's shift and conv rows are held to against another
    device or the reference."""
    diff = (a.cpu().float() - b.cpu().float()).abs()
    return bool(((bf16_ulps(a, b) <= 1) | (diff <= atol)).all())
