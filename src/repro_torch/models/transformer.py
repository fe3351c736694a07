"""Layer parameters and the layer-stack loops of the dense and moe
families — port of ``src/repro/models/transformer.py:51-68, 92-128,
140-325``.

The reference stacks layer parameters on a leading (L, ...) axis and scans
over them with per-layer flag arrays; the port keeps one
:class:`DecoderLayer` module per layer (``DenseLM.layers``) and loops in
Python, reading the same flags (``layer_flags``) as Python values.  The
reference's ``remat`` and ``scan_unroll`` are training and dry-run knobs and
have no effect here.  The ssm, hybrid, audio and vlm families are refused
(ROADMAP Queue 1 item 9.5).

Two loops: ``stack_forward`` (train / prefill; optionally fills a KV
cache), ``stack_decode`` (one token against the cache).  The MoE aux loss
is summed over the layers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import (Attention, attn_param_specs, decode_attention,
                        full_attention, write_cache_prefill)
from .common import register_params, rms_norm
from .mlp import MLP, mlp, mlp_param_specs
from .moe import MoE, moe_ffn, moe_param_specs

FAMILIES = ("dense", "moe")


def _norm_spec(cfg: ModelConfig) -> tuple:
    return ((cfg.d_model,), (None,))


def check_family(cfg: ModelConfig) -> None:
    """Refuse a config of a family the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"the port runs the dense and moe families only; {cfg.name!r} is "
            f"{cfg.family!r} (ROADMAP Queue 1 item 9.5: the ssm, hybrid, "
            "audio and vlm families)")


def layer_param_specs(cfg: ModelConfig) -> dict:
    """Nested name -> (shape, logical_axes) for ONE layer (unstacked)."""
    check_family(cfg)
    p = {"ln1": _norm_spec(cfg), "attn": attn_param_specs(cfg),
         "ln2": _norm_spec(cfg)}
    if cfg.family == "moe":
        p["ffn"] = moe_param_specs(cfg)
    else:
        p["ffn"] = mlp_param_specs(cfg)
    if cfg.post_norm:
        p["ln1_post"] = _norm_spec(cfg)
        p["ln2_post"] = _norm_spec(cfg)
    return p


class DecoderLayer(torch.nn.Module):
    """``ln1``, ``attn`` (:class:`Attention`), ``ln2``, ``ffn``
    (:class:`MLP`, or :class:`MoE` for the moe family), plus ``ln1_post
    ln2_post`` when the config has post-sublayer norms."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        specs = layer_param_specs(cfg)
        self.attn = Attention(cfg, dtype, device)
        self.ffn = (MoE if cfg.family == "moe" else MLP)(cfg, dtype, device)
        register_params(self, {k: v for k, v in specs.items()
                               if k not in ("attn", "ffn")}, dtype, device)


def n_attn_layers(cfg: ModelConfig) -> int:
    """Rows in the self-attention KV cache stack."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return int(np.sum(np.arange(cfg.n_layers) % cfg.shared_attn_period == 0))
    return cfg.n_layers


def layer_flags(cfg: ModelConfig) -> dict:
    """Static per-layer flag arrays (numpy), as in the reference."""
    L = cfg.n_layers
    idx = np.arange(L, dtype=np.int32)
    flags = {"idx": idx}
    if cfg.local_global_period:
        flags["sliding"] = (idx % cfg.local_global_period) == 0
    else:
        flags["sliding"] = np.zeros(L, dtype=bool)
    if cfg.shared_attn_period:
        has = (idx % cfg.shared_attn_period) == 0
        flags["has_attn"] = has
        flags["attn_idx"] = (np.cumsum(has) - 1).astype(np.int32)
    if cfg.cross_attn_period:
        has = (idx % cfg.cross_attn_period) == 0
        flags["has_cross"] = has
        flags["cross_idx"] = (np.cumsum(has) - 1).astype(np.int32)
    return flags


def _maybe(pred, fn, operand):
    """``fn(operand)`` if ``pred`` else ``operand``: the reference's gate of
    a layer's optional sublayer (its unrolled form), for the hybrid and vlm
    families."""
    return fn(operand) if bool(pred) else operand


def _tree_at(tree, i):
    """Row ``i`` of every array of a nested dict of (L, ...) arrays."""
    if isinstance(tree, dict):
        return {k: _tree_at(v, i) for k, v in tree.items()}
    return tree[i]


def _ffn(cfg: ModelConfig, p: DecoderLayer, x: torch.Tensor):
    """The layer's FFN sublayer on the pre-norm of ``x``: (out, aux)."""
    h = rms_norm(x, p.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        ff, aux = moe_ffn(cfg, p.ffn, h)
    else:
        ff, aux = mlp(cfg, p.ffn, h), None
    if cfg.post_norm:
        ff = rms_norm(ff, p.ln2_post, cfg.norm_eps)
    return ff, aux


# ------------------------------------------------------------------ forward

def stack_forward(cfg: ModelConfig, layers, x: torch.Tensor,
                  positions: torch.Tensor, *, cache: Optional[dict] = None):
    """Run the layer stack (``DenseLM.layers``) over x (B,S,D).  Returns
    (x, aux, cache).

    ``cache`` not None => prefill mode: each layer's k/v are written into
    it (in place)."""
    check_family(cfg)
    flags = layer_flags(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, p in enumerate(layers):
        a, k, v = full_attention(cfg, p.attn,
                                 rms_norm(x, p.ln1, cfg.norm_eps),
                                 positions, bool(flags["sliding"][i]))
        if cfg.post_norm:
            a = rms_norm(a, p.ln1_post, cfg.norm_eps)
        x = x + a
        if cache is not None:
            write_cache_prefill(cfg, cache, i, k, v)
        ff, a_loss = _ffn(cfg, p, x)
        if a_loss is not None:
            aux = aux + a_loss
        x = x + ff
    return x, aux, cache


# ------------------------------------------------------------------- decode

def stack_decode(cfg: ModelConfig, layers, x: torch.Tensor,
                 pos: torch.Tensor, *, cache: Optional[dict] = None,
                 state: Optional[dict] = None):
    """One-token step through the stack.  x (B,1,D), pos (B,) integer.

    Returns (x, cache, state) with the cache updated at ``pos`` in place;
    ``state`` (the recurrent families') passes through."""
    check_family(cfg)
    flags = layer_flags(cfg)
    cache = cache if cache is not None else {}
    state = state if state is not None else {}
    for i, p in enumerate(layers):
        a, cache = decode_attention(cfg, p.attn,
                                    rms_norm(x, p.ln1, cfg.norm_eps),
                                    cache, i, pos, bool(flags["sliding"][i]))
        if cfg.post_norm:
            a = rms_norm(a, p.ln1_post, cfg.norm_eps)
        x = x + a
        x = x + _ffn(cfg, p, x)[0]
    return x, cache, state
