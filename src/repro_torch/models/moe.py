"""Mixture-of-Experts FFN with sort-based capacity dispatch — port of
``src/repro/models/moe.py``.

The reference groups tokens by their data-parallel shard
(``_dispatch_groups``); on one device there is one group (G = 1), so the
port drops that axis.  Dispatch is the reference's: a stable argsort of the
routed expert ids, each expert's queue start by ``searchsorted``, a slot
``expert * C + rank`` for the first C tokens of each queue and the drop bin
``E * C`` for the rest.  The combine is an ``index_add_`` (the reference's
``.at[i].add``), which the card runs with atomics: its sums may differ from
run to run in the last bits.  The two gathers are ``index_select``s, whose
backward is such an ``index_add_`` too: an indexing gather's backward
sorts its indices and sums each row's duplicates in one thread, and the
clamped ``dst`` sends every dropped token to one row (44% of granite-moe's
full-width train step on an H100 went there).
"""
from __future__ import annotations

import types

import torch

from ..configs.base import ModelConfig
from .common import act_fn, register_params
from .mlp import mlp, mlp_param_specs


def moe_param_specs(cfg: ModelConfig) -> dict:
    """name -> (shape, logical_axes)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {
        "router": ((d, e), ("embed", None)),
        "we_gate": ((e, d, f), ("experts", "embed", "mlp")),
        "we_up": ((e, d, f), ("experts", "embed", "mlp")),
        "we_down": ((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        p.update({f"shared_{k}": v for k, v in
                  mlp_param_specs(cfg, cfg.n_shared_experts * cfg.d_ff).items()})
    return p


class MoE(torch.nn.Module):
    """``router`` (d, E), ``we_gate we_up`` (E, d, f), ``we_down`` (E, f, d),
    plus the shared experts' dense FFN as ``shared_w_gate shared_w_up
    shared_w_down`` when the config has them."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device=None):
        super().__init__()
        register_params(self, moe_param_specs(cfg), dtype, device)


def _capacity(cfg: ModelConfig, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """x (B,S,D) -> (out (B,S,D), aux_loss float32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    dev = x.device
    xt = x.reshape(T, D)
    logits = (xt @ p.router.to(x.dtype)).float()                    # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = torch.topk(probs, K, dim=-1, sorted=True)       # (T,K)
    gate_v = gate_v / gate_v.sum(-1, keepdim=True)

    # ---- sort-based dispatch ---------------------------------------------
    C = max(_capacity(cfg, T), 4)
    fe = gate_i.reshape(T * K)                       # flat expert ids
    fw = gate_v.reshape(T * K)
    ft = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(fe, stable=True)
    se, st, sw = fe[order], ft[order], fw[order]
    # position of each routed token within its expert's queue
    start = torch.searchsorted(se, torch.arange(E, device=dev), side="left")
    pos_in_e = torch.arange(T * K, device=dev) - start[se]
    keep = pos_in_e < C
    dst = torch.where(keep, se * C + pos_in_e, E * C)  # E*C = drop bin
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=dev)
    buf[dst] = xt.index_select(0, st)
    buf = buf[:E * C].reshape(E, C, D)

    # ---- expert FFN -------------------------------------------------------
    a = act_fn(cfg.act)
    h = a(torch.einsum("ecd,edf->ecf", buf, p.we_gate.to(x.dtype))) \
        * torch.einsum("ecd,edf->ecf", buf, p.we_up.to(x.dtype))
    out_e = torch.einsum("ecf,efd->ecd", h, p.we_down.to(x.dtype))

    # ---- combine ----------------------------------------------------------
    flat = out_e.reshape(E * C, D)
    gathered = flat.index_select(0, dst.clamp(max=E * C - 1))
    gathered = torch.where(keep[:, None], gathered, 0)
    contrib = gathered * sw[:, None].to(x.dtype)
    y = torch.zeros((T, D), dtype=x.dtype, device=dev).index_add_(
        0, st, contrib).reshape(B, S, D)

    # ---- aux loss ---------------------------------------------------------
    me = probs.mean(0)                                            # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, fe, torch.ones(T * K, device=dev)) / (T * K)
    aux = (me * ce).sum() * E

    if cfg.n_shared_experts:
        shared = types.SimpleNamespace(**{
            k[len("shared_"):]: v for k, v in p.named_parameters()
            if k.startswith("shared_")})
        y = y + mlp(cfg, shared, x)
    return y, aux
