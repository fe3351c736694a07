"""AdamW with decoupled weight decay, global-norm clipping and a cosine
schedule, over trees of tensors — port of ``src/repro/optim/adamw.py``.

A tree is nested dicts, lists and tuples of tensors, walked in JAX's order
(:mod:`repro_torch.tree`); the train step passes a model's parameters as
the dict ``dict(model.named_parameters())``, and ``adamw_init`` takes the
model itself too.  The moments are float32 and the step counter an int32
scalar, on the parameters' device; the schedule and the bias corrections
are float32 scalar tensors there, as the reference computes them, so a
step never reads a value back to the host.

Unlike the reference, which returns new trees, ``adamw_update`` writes the
parameters and the moments IN PLACE, one leaf at a time (so a step's
temporaries are one leaf's, not a second copy of the parameters), and
returns the same trees.  The reference's per-leaf formula is kept
operation for operation.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr; a float32 scalar
    tensor on ``step``'s device (``step`` an integer or a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _tree(params):
    """A model's parameters as the dict the optimizer walks; any other tree
    as it is."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def adamw_init(params) -> dict:
    """Zero float32 moments mirroring ``params`` (a tree of tensors or a
    model) and a zero int32 step, on the parameters' device."""
    params = _tree(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device if leaves(params) else None
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_state_specs(param_spec_tree, spec_cls) -> dict:
    """Spec tree for the optimizer state (moments mirror param axes, f32)."""
    f32 = lambda s: spec_cls(s.shape, "float32", s.axes)  # noqa: E731
    return {"mu": tree_map(f32, param_spec_tree),
            "nu": tree_map(f32, param_spec_tree),
            "step": spec_cls((), "int32", ())}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``.
    Returns (clipped grads, gnorm float32 scalar); the squares are summed
    leaf by leaf in the tree's order, as the reference sums them."""
    gs = leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in gs))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step, in place.  Returns (params, state, lr): the same
    trees, updated."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    stepf = step.to(torch.float32)
    b1t = 1 - torch.pow(cfg.b1, stepf)
    b2t = 1 - torch.pow(cfg.b2, stepf)

    def upd(p, g, mu, nu):
        g = g.float()
        mu.copy_(cfg.b1 * mu + (1 - cfg.b1) * g)
        nu.copy_(cfg.b2 * nu + (1 - cfg.b2) * torch.square(g))
        mhat = mu / b1t
        nhat = nu / b2t
        pf = p.float()
        pf = pf - lr * (mhat / (torch.sqrt(nhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(pf)

    cols = [leaves(t) for t in (params, grads, state["mu"], state["nu"])]
    if any(len(c) != len(cols[0]) for c in cols):
        raise ValueError("params, grads and moments differ in structure")
    for p, g, m, n in zip(*cols):
        upd(p, g, m, n)
    state["step"].copy_(step)
    return params, state, lr
