"""Mixture-of-Experts FFN with sort-based capacity dispatch — port of
``src/repro/models/moe.py``.

The reference groups tokens by their data-parallel shard: G groups
(``_dispatch_groups``, read from the installed ``ShardingContext``: the
mesh's extent over ('pod', 'data', 'model'), halved until it divides the
batch; 1 without a context), each scattering into its own (E, C) slice
of the expert buffers with ``C = max(capacity(T) // G, 4)``, so tokens kept
with G = 1 can be dropped with G > 1.  This is the one place where a
context changes the numbers.  The port does the same: the groups' slices
lie expert-major, ``(E, G, C)``, so the expert FFN runs on ``(E, G*C, D)``
rows and with G = 1 every floating-point operation sees the tensors it saw
before groups existed (bit for bit).  Dispatch (:func:`dispatch`) is the
reference's: a stable argsort of each group's routed expert ids, each
expert's queue start by ``searchsorted``, a slot ``(expert, group, rank)``
for the first C tokens of each queue and the drop bin ``E * G * C`` for
the rest.  The combine is an ``index_add_`` (the reference's
``.at[i].add``), which the card runs with atomics: its sums may differ
from run to run in the last bits.  The two gathers are ``index_select``s, whose backward is such an
``index_add_`` too: an indexing gather's backward sorts its indices and
sums each row's duplicates in one thread, and the clamped ``dst`` sends
every dropped token to one row (44% of granite-moe's full-width train
step on an H100 went there).
"""
from __future__ import annotations

import types

import torch

from ..configs.base import ModelConfig
from ..parallel.sharding import get_context
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


def _dispatch_groups(B: int) -> int:
    """Shard-local dispatch group count = the mesh's DP extent (if any)."""
    ctx = get_context()
    if ctx is None:
        return 1
    g = 1
    for ax in ("pod", "data", "model"):
        if ax in ctx.mesh.axis_names:
            g *= ctx.mesh.shape[ax]
    while g > 1 and B % g != 0:
        g //= 2
    return max(g, 1)


def dispatch(gate_i: torch.Tensor, gate_v: torch.Tensor, E: int, G: int,
             C: int):
    """The slots of the routes ``gate_i`` (T, K), weights ``gate_v``, in G
    groups of T // G tokens and C slots an expert: (keep, dst, tok, sw),
    flat over (group, rank in the group's sorted routes).  ``keep`` marks
    the first C routes of each group's expert queue, ``dst`` is a kept
    route's row ``(expert * G + group) * C + rank`` (``E * G * C``, the
    drop bin, for the rest), ``tok`` its token, ``sw`` (G, T // G * K) its
    weight."""
    T, K = gate_i.shape
    TL = T // G
    dev = gate_i.device
    fe = gate_i.reshape(G, TL * K)                   # flat expert ids
    fw = gate_v.reshape(G, TL * K)
    ft = torch.arange(TL, device=dev).repeat_interleave(K).expand(G, -1)
    order = torch.argsort(fe, dim=-1, stable=True)
    se, st, sw = fe.gather(1, order), ft.gather(1, order), fw.gather(1, order)
    # position of each routed token within its expert's per-group queue
    start = torch.searchsorted(
        se, torch.arange(E, device=dev).expand(G, -1).contiguous(),
        side="left")
    pos_in_e = torch.arange(TL * K, device=dev) - start.gather(1, se)
    keep = (pos_in_e < C).reshape(-1)
    g = torch.arange(G, device=dev)[:, None]
    dst = torch.where(keep, ((se * G + g) * C + pos_in_e).reshape(-1),
                      E * G * C)                     # E*G*C = drop bin
    tok = (g * TL + st).reshape(-1)                  # token of each entry
    return keep, dst, tok, sw


def moe_ffn(cfg: ModelConfig, p: MoE, x: torch.Tensor):
    """x (B,S,D) -> (out (B,S,D), aux_loss float32 scalar)."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    G = _dispatch_groups(B)
    dev = x.device
    xt = x.reshape(T, D)
    logits = (xt @ p.router.to(x.dtype)).float()                    # (T,E)
    probs = torch.softmax(logits, dim=-1)
    gate_v, gate_i = torch.topk(probs, K, dim=-1, sorted=True)       # (T,K)
    gate_v = gate_v / gate_v.sum(-1, keepdim=True)

    # ---- group-local sort-based dispatch ---------------------------------
    C = max(_capacity(cfg, T) // G, 4)
    keep, dst, tok, sw = dispatch(gate_i, gate_v, E, G, C)
    buf = torch.zeros((E * G * C + 1, D), dtype=x.dtype, device=dev)
    buf[dst] = xt.index_select(0, tok)
    buf = buf[:E * G * C].reshape(E, G * C, D)

    # ---- expert FFN -------------------------------------------------------
    a = act_fn(cfg.act)
    h = a(torch.einsum("ecd,edf->ecf", buf, p.we_gate.to(x.dtype))) \
        * torch.einsum("ecd,edf->ecf", buf, p.we_up.to(x.dtype))
    out_e = torch.einsum("ecf,efd->ecd", h, p.we_down.to(x.dtype))

    # ---- group-local combine --------------------------------------------
    flat = out_e.reshape(E * G * C, D)
    gathered = flat.index_select(0, dst.clamp(max=E * G * C - 1))
    gathered = torch.where(keep[:, None], gathered, 0)
    contrib = gathered * sw.reshape(-1)[:, None].to(x.dtype)
    y = torch.zeros((T, D), dtype=x.dtype, device=dev).index_add_(
        0, tok, contrib).reshape(B, S, D)

    # ---- aux loss ---------------------------------------------------------
    me = probs.mean(0)                                            # (E,)
    ce = torch.zeros(E, dtype=torch.float32, device=dev).index_add_(
        0, gate_i.reshape(-1), torch.ones(T * K, device=dev)) / (T * K)
    aux = (me * ce).sum() * E

    if cfg.n_shared_experts:
        shared = types.SimpleNamespace(**{
            k[len("shared_"):]: v for k, v in p.named_parameters()
            if k.startswith("shared_")})
        y = y + mlp(cfg, shared, x)
    return y, aux
