"""Layer parameters and the layer-stack loops of every family — port of
``src/repro/models/transformer.py``.

The reference stacks layer parameters on a leading (L, ...) axis and scans
over them with per-layer flag arrays; the port keeps one layer module per
layer (``DenseLM.layers``: :class:`DecoderLayer` for the dense, moe, audio
and vlm families, :class:`RWKVLayer` for ssm, :class:`MambaLayer` for
hybrid) and loops in Python, reading the same flags (``layer_flags``) as
Python values.  The non-stacked extras (``DenseLM.extras``) are zamba2's
one shared attention block (``shared_attn``, applied where ``has_attn``,
its cache row ``attn_idx``) and the vlm's cross-attention layers
(``cross``, one :class:`AttnBlock` per row of the reference's
(n_cross, ...) stack, applied where ``has_cross`` as row ``cross_idx``).
The reference's ``remat`` and ``scan_unroll`` are training and dry-run
knobs and have no effect here.

Two loops: ``stack_forward`` (train / prefill; optionally fills a KV
cache and, for the vlm, the cross k/v once per cross layer) and
``stack_decode`` (one token against the cache and the recurrent state).
As in the reference, a prefill fills only attention caches: the ssm and
hybrid families' recurrent state is not seeded by it.  The MoE aux loss is
summed over the layers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from .attention import (Attention, attn_param_specs, cross_attention,
                        cross_kv, decode_attention, full_attention,
                        write_cache_prefill)
from .common import register_params, rms_norm
from .mamba2 import Mamba2, mamba_block, mamba_decode, mamba_param_specs
from .mlp import MLP, mlp, mlp_param_specs
from .moe import MoE, moe_ffn, moe_param_specs
from .rwkv6 import (RWKV, channel_mix, rwkv_channel_decode, rwkv_decode,
                    rwkv_param_specs, time_mix)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def _norm_spec(cfg: ModelConfig) -> tuple:
    return ((cfg.d_model,), (None,))


def check_family(cfg: ModelConfig) -> None:
    """Refuse a config of a family the reference does not know."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name!r} is of family {cfg.family!r}; the "
                         f"families are {FAMILIES}")


def layer_param_specs(cfg: ModelConfig) -> dict:
    """Nested name -> (shape, logical_axes) for ONE layer (unstacked)."""
    check_family(cfg)
    if cfg.family == "hybrid":
        return {"norm": _norm_spec(cfg), "ssm": mamba_param_specs(cfg)}
    if cfg.family == "ssm":
        return {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg),
                "tm": rwkv_param_specs(cfg)}
    # dense / moe / audio / vlm
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


def _vectors(cfg: ModelConfig, module: torch.nn.Module, dtype, device,
             subs: tuple) -> None:
    """Register the layer's own parameters: its specs but ``subs`` (the
    sublayers, which are modules of their own)."""
    register_params(module, {k: v for k, v in layer_param_specs(cfg).items()
                             if k not in subs}, dtype, device)


class DecoderLayer(torch.nn.Module):
    """``ln1``, ``attn`` (:class:`Attention`), ``ln2``, ``ffn``
    (:class:`MLP`, or :class:`MoE` for the moe family), plus ``ln1_post
    ln2_post`` when the config has post-sublayer norms (the dense, moe,
    audio and vlm families)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        self.ffn = (MoE if cfg.family == "moe" else MLP)(cfg, dtype, device)
        _vectors(cfg, self, dtype, device, ("attn", "ffn"))


class RWKVLayer(torch.nn.Module):
    """An ssm-family layer: ``ln1``, ``ln2`` and ``tm`` (:class:`RWKV`,
    the time-mix and channel-mix parameters)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.tm = RWKV(cfg, dtype, device)
        _vectors(cfg, self, dtype, device, ("tm",))


class MambaLayer(torch.nn.Module):
    """A hybrid-family layer: ``norm`` and ``ssm`` (:class:`Mamba2`)."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.ssm = Mamba2(cfg, dtype, device)
        _vectors(cfg, self, dtype, device, ("ssm",))


def make_layer(cfg: ModelConfig, dtype: torch.dtype,
               device=None) -> torch.nn.Module:
    """One layer module of ``cfg``'s family."""
    cls = {"ssm": RWKVLayer, "hybrid": MambaLayer}.get(cfg.family,
                                                      DecoderLayer)
    return cls(cfg, dtype, device)


class AttnBlock(torch.nn.Module):
    """``ln`` and ``attn``: zamba2's shared attention block, or one vlm
    cross-attention layer."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        self.attn = Attention(cfg, dtype, device)
        register_params(self, {"ln": _norm_spec(cfg)}, dtype, device)


def extra_param_specs(cfg: ModelConfig) -> dict:
    """Non-stacked extras: zamba2 shared attention, the vlm cross stack
    (each leaf (n_cross, ...), as in the reference)."""
    out: dict = {}
    if cfg.shared_attn_period:
        out["shared_attn"] = {"ln": _norm_spec(cfg),
                              "attn": attn_param_specs(cfg)}
    if cfg.cross_attn_period:
        nc = n_cross_layers(cfg)

        def stack(specs: dict) -> dict:
            return {k: stack(s) if isinstance(s, dict)
                    else ((nc,) + tuple(s[0]), ("layers",) + tuple(s[1]))
                    for k, s in specs.items()}

        out["cross"] = stack({"ln": _norm_spec(cfg),
                              "attn": attn_param_specs(cfg, cross=True)})
    return out


def make_extras(cfg: ModelConfig, dtype: torch.dtype,
                device=None) -> torch.nn.ModuleDict:
    """The extras of :func:`extra_param_specs` as modules (empty for the
    families without any): ``shared_attn`` an :class:`AttnBlock`, ``cross``
    a list of n_cross_layers of them."""
    out = torch.nn.ModuleDict()
    if cfg.shared_attn_period:
        out["shared_attn"] = AttnBlock(cfg, dtype, device)
    if cfg.cross_attn_period:
        out["cross"] = torch.nn.ModuleList(
            AttnBlock(cfg, dtype, device) for _ in range(n_cross_layers(cfg)))
    return out


def n_attn_layers(cfg: ModelConfig) -> int:
    """Rows in the self-attention KV cache stack."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return int(np.sum(np.arange(cfg.n_layers) % cfg.shared_attn_period == 0))
    return cfg.n_layers


def n_cross_layers(cfg: ModelConfig) -> int:
    if not cfg.cross_attn_period:
        return 0
    return int(np.sum(np.arange(cfg.n_layers) % cfg.cross_attn_period == 0))


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
                  positions: torch.Tensor, *, extras=None,
                  memory: Optional[torch.Tensor] = None,
                  cache: Optional[dict] = None):
    """Run the layer stack (``DenseLM.layers``, with ``DenseLM.extras``)
    over x (B,S,D); ``memory`` (B,P,D) is the vlm's patch embeddings.
    Returns (x, aux, cache).

    ``cache`` not None => prefill mode: self-attention k/v (and, for the
    vlm, the cross k/v of every cross layer, computed once) are written
    into it, in place."""
    flags = layer_flags(cfg)
    fill = cache is not None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if fill and cfg.cross_attn_period:
        # the cross k/v once per cross layer (memory is fixed per request)
        for j, cp in enumerate(extras["cross"]):
            k, v = cross_kv(cfg, cp.attn, memory)
            cache["xk"][j] = k
            cache["xv"][j] = v
    for i, p in enumerate(layers):
        if cfg.family == "hybrid":
            if cfg.shared_attn_period:
                sh = extras["shared_attn"]

                def do_attn(x, row=int(flags["attn_idx"][i])):
                    a, k, v = full_attention(cfg, sh.attn,
                                             rms_norm(x, sh.ln, cfg.norm_eps),
                                             positions)
                    if fill:
                        write_cache_prefill(cfg, cache, row, k, v)
                    return x + a

                x = _maybe(flags["has_attn"][i], do_attn, x)
            x = x + mamba_block(cfg, p.ssm, rms_norm(x, p.norm, cfg.norm_eps))
        elif cfg.family == "ssm":
            x = x + time_mix(cfg, p.tm, rms_norm(x, p.ln1, cfg.norm_eps))
            x = x + channel_mix(cfg, p.tm, rms_norm(x, p.ln2, cfg.norm_eps))
        else:
            a, k, v = full_attention(cfg, p.attn,
                                     rms_norm(x, p.ln1, cfg.norm_eps),
                                     positions, bool(flags["sliding"][i]))
            if cfg.post_norm:
                a = rms_norm(a, p.ln1_post, cfg.norm_eps)
            x = x + a
            if fill:
                write_cache_prefill(cfg, cache, i, k, v)
            if cfg.cross_attn_period:
                cp = extras["cross"][int(flags["cross_idx"][i])]
                x = _maybe(flags["has_cross"][i], lambda x: x + cross_attention(
                    cfg, cp.attn, rms_norm(x, cp.ln, cfg.norm_eps),
                    memory=memory), x)
            ff, a_loss = _ffn(cfg, p, x)
            if a_loss is not None:
                aux = aux + a_loss
            x = x + ff
    return x, aux, cache


# ------------------------------------------------------------------- decode

def stack_decode(cfg: ModelConfig, layers, x: torch.Tensor,
                 pos: torch.Tensor, *, extras=None,
                 cache: Optional[dict] = None,
                 state: Optional[dict] = None):
    """One-token step through the stack.  x (B,1,D), pos (B,) integer.

    Returns (x, cache, state): the cache written at ``pos`` and the
    recurrent state's rows updated, both in place."""
    flags = layer_flags(cfg)
    cache = cache if cache is not None else {}
    state = state if state is not None else {}
    for i, p in enumerate(layers):
        if cfg.family == "hybrid":
            if cfg.shared_attn_period:
                sh = extras["shared_attn"]

                def do_attn(x, row=int(flags["attn_idx"][i])):
                    a, _ = decode_attention(cfg, sh.attn,
                                            rms_norm(x, sh.ln, cfg.norm_eps),
                                            cache, row, pos)
                    return x + a

                x = _maybe(flags["has_attn"][i], do_attn, x)
            h, state = mamba_decode(cfg, p.ssm,
                                    rms_norm(x, p.norm, cfg.norm_eps),
                                    state, i)
            x = x + h
        elif cfg.family == "ssm":
            h, state = rwkv_decode(cfg, p.tm,
                                   rms_norm(x, p.ln1, cfg.norm_eps), state, i)
            x = x + h
            h, state = rwkv_channel_decode(cfg, p.tm,
                                           rms_norm(x, p.ln2, cfg.norm_eps),
                                           state, i)
            x = x + h
        else:
            a, cache = decode_attention(cfg, p.attn,
                                        rms_norm(x, p.ln1, cfg.norm_eps),
                                        cache, i, pos,
                                        bool(flags["sliding"][i]))
            if cfg.post_norm:
                a = rms_norm(a, p.ln1_post, cfg.norm_eps)
            x = x + a
            if cfg.cross_attn_period:
                j = int(flags["cross_idx"][i])
                cp = extras["cross"][j]
                kv = (cache["xk"][j], cache["xv"][j])
                x = _maybe(flags["has_cross"][i], lambda x: x + cross_attention(
                    cfg, cp.attn, rms_norm(x, cp.ln, cfg.norm_eps), kv=kv), x)
            x = x + _ffn(cfg, p, x)[0]
    return x, cache, state
