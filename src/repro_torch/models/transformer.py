"""Layer parameters of the dense family — port of
``src/repro/models/transformer.py:51-68, 92-98, 127-128``.

The reference stacks layer parameters on a leading (L, ...) axis and scans
over them; the port keeps one :class:`DecoderLayer` module per layer
(``DenseLM.layers``) and loops in Python.  The stacked-layer loops
(``stack_forward``, ``stack_decode``) and the other families (moe, ssm,
hybrid, audio, vlm) come later (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import Attention, attn_param_specs
from .common import register_params
from .mlp import MLP, mlp_param_specs


def _norm_spec(cfg: ModelConfig) -> tuple:
    return ((cfg.d_model,), (None,))


def _dense_only(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"the port serves the dense family only; {cfg.name!r} is "
            f"{cfg.family!r} (ROADMAP Queue 1 item 9: the moe, ssm, hybrid, "
            "audio and vlm families)")


def layer_param_specs(cfg: ModelConfig) -> dict:
    """Nested name -> (shape, logical_axes) for ONE layer (unstacked)."""
    _dense_only(cfg)
    p = {"ln1": _norm_spec(cfg), "attn": attn_param_specs(cfg),
         "ln2": _norm_spec(cfg), "ffn": mlp_param_specs(cfg)}
    if cfg.post_norm:
        p["ln1_post"] = _norm_spec(cfg)
        p["ln2_post"] = _norm_spec(cfg)
    return p


class DecoderLayer(torch.nn.Module):
    """``ln1``, ``attn`` (:class:`Attention`), ``ln2``, ``ffn``
    (:class:`MLP`), plus ``ln1_post ln2_post`` when the config has
    post-sublayer norms."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        specs = layer_param_specs(cfg)
        self.attn = Attention(cfg, dtype, device)
        self.ffn = MLP(cfg, dtype, device)
        register_params(self, {k: v for k, v in specs.items()
                               if k not in ("attn", "ffn")}, dtype, device)


def n_attn_layers(cfg: ModelConfig) -> int:
    """Rows in the self-attention KV cache stack."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return int(np.sum(np.arange(cfg.n_layers) % cfg.shared_attn_period == 0))
    return cfg.n_layers


def _tree_at(tree, i):
    """Row ``i`` of every array of a nested dict of (L, ...) arrays."""
    if isinstance(tree, dict):
        return {k: _tree_at(v, i) for k, v in tree.items()}
    return tree[i]
