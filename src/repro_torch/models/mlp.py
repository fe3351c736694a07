"""Dense FFN (SwiGLU / GeLU-MLP) — port of ``src/repro/models/mlp.py``."""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import act_fn, register_params


def mlp_param_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    """name -> (shape, logical_axes)."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"w_gate": ((d, f), ("embed", "mlp")),
            "w_up": ((d, f), ("embed", "mlp")),
            "w_down": ((f, d), ("mlp", "embed"))}


class MLP(torch.nn.Module):
    """``w_gate``, ``w_up`` (d, f) and ``w_down`` (f, d), in the reference's
    (in, out) orientation: ``x @ w``."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        register_params(self, mlp_param_specs(cfg), dtype, device)


def mlp(cfg: ModelConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    a = act_fn(cfg.act)
    h = a(x @ p.w_gate.to(x.dtype)) * (x @ p.w_up.to(x.dtype))
    return h @ p.w_down.to(x.dtype)
