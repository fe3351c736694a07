"""Step functions (train / prefill / decode) — port of
``src/repro/launch/steps.py``.

These are the units a launcher executes: ``make_train_step(cfg, opt_cfg)``,
``make_prefill_step(cfg)`` and ``make_decode_step(cfg)`` return functions
with the reference's signatures over :mod:`repro_torch.models.model`, the
model (a ``DenseLM``) in the place of the parameter tree.  The device is
fixed when the step is made: ``cuda:0`` unless ``device`` names another
(``"cpu"`` for the plain path); without CUDA the default raises.  State is
updated in place, as the reference's donated buffers are: the train step
writes the model's parameters and the optimizer state, the prefill and
decode steps the caches and recurrent states.  As in the reference, the
decode step passes the cache only to a family that has one
(``cache_specs`` non-empty) and the state only to one that has one
(``state_specs`` non-empty), and returns ``{}`` in the place of either that
it does not have.  :func:`shardings_for` gives a spec tree's shardings
under the reference's rule tables as spec tuples (nothing places a tensor
by them: the dry-run counts a device's bytes with them).

    step = make_train_step(cfg)                   # on cuda:0
    opt_state = adamw_init(model)
    model, opt_state, metrics = step(model, opt_state, batch)
    step = make_decode_step(cfg)
    logits, nxt, cache, state = step(model, tokens, pos, cache, state)
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..device import resolve
from ..models import model as M
from ..optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                     opt_state_specs)
from ..parallel.sharding import (ACT_RULES, PARAM_RULES, NamedSharding,
                                 spec_for)
from ..tree import tree_map


def shardings_for(spec_tree, mesh, *, params: bool):
    """Spec tree -> tree of spec tuples (``PARAM_RULES`` or
    ``ACT_RULES``), the reference's ``NamedSharding`` tree without the
    mesh."""
    rules = PARAM_RULES if params else ACT_RULES
    return tree_map(lambda s: spec_for(s.shape, s.axes, mesh, rules),
                    spec_tree)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


# ------------------------------------------------------------------ train


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    device=None):
    """One optimizer step: the loss (``loss_fn``) and its gradient by
    autograd, ``clip_by_global_norm``, then ``adamw_update``.
    ``train_step(model, opt_state, batch)`` turns gradients on for the
    model's parameters (they stay on), writes the parameters and
    ``opt_state`` (``adamw_init(model)``'s dict: moments keyed by parameter
    name) in place and returns (model, opt_state, metrics): ``loss``,
    ``aux``, ``gnorm`` and ``lr``, float32 scalar tensors on the device.
    The batch holds ``tokens`` (``frames`` for the audio stub), ``labels``
    and, for the vlm, ``patches``, as numpy arrays or tensors.  The
    reference's ``optimization_barrier`` before the clip has no
    counterpart: on one device there is no gradient all-reduce for it to
    pin."""
    opt_cfg = opt_cfg or AdamWConfig()
    dev = resolve(device)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = M.loss_fn(cfg, model, batch, device=dev)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        grads, gnorm = clip_by_global_norm(dict(zip(params, grads)),
                                           opt_cfg.clip_norm)
        _, opt_state, lr = adamw_update(opt_cfg, params, grads, opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return model, opt_state, dict(metrics, gnorm=gnorm, lr=lr)

    return train_step


def train_cell_specs(cfg: ModelConfig, shape) -> tuple:
    """(param_specs, opt_specs, batch_specs) Spec trees for one train cell."""
    pspecs = M.param_spec_tree(cfg)
    ospecs = opt_state_specs(pspecs, M.Spec)
    bspecs = M.input_specs(cfg, shape)
    return pspecs, ospecs, bspecs


# ------------------------------------------------------------------ prefill

def make_prefill_step(cfg: ModelConfig, device=None):
    dev = resolve(device)

    def prefill_step(params, batch, cache):
        return M.prefill(cfg, params, batch, cache, device=dev)

    return prefill_step


# ------------------------------------------------------------------- decode

def make_decode_step(cfg: ModelConfig, device=None):
    dev = resolve(device)
    has_cache = len(M.cache_specs(cfg, 1, 8)) > 0
    has_state = len(M.state_specs(cfg, 1)) > 0

    def decode_one(params, tokens, pos, cache, state):
        logits, nxt, cache, state = M.decode_step(
            cfg, params, tokens, pos, cache if has_cache else None,
            state if has_state else None, device=dev)
        return (logits, nxt, cache if has_cache else {},
                state if has_state else {})

    return decode_one
