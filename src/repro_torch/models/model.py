"""Model assembly of the dense family: parameter specs, the ``DenseLM``
module, its initialisation, the LM head, and the carry-over of the
reference's parameter tree — port of ``src/repro/models/model.py:48-110,
175-179``.

Parameter names equal the reference's keys (``layers.3.attn.wq`` is row 3
of the reference's ``params["layers"]["attn"]["wq"]``) and matrices keep
its (in, out) orientation.  The train forward, the loss and the
contiguous-cache decode come later (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .common import dtype_of, register_params, softcap
from .transformer import DecoderLayer, _dense_only, _tree_at, layer_param_specs


def param_specs(cfg: ModelConfig) -> dict:
    """Nested name -> shape tuple of the reference's parameter tree (layer
    parameters stacked over a leading L axis)."""
    _dense_only(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    out: dict = {"embed": (v, d)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (d, v)
    out["final_norm"] = (d,)

    def stack(specs: dict) -> dict:
        return {k: stack(s) if isinstance(s, dict)
                else (cfg.n_layers,) + tuple(s[0]) for k, s in specs.items()}

    out["layers"] = stack(layer_param_specs(cfg))
    return out


class DenseLM(torch.nn.Module):
    """``embed`` (V, D), ``lm_head`` (D, V) unless tied, ``final_norm``
    (D,), and ``layers``: one :class:`DecoderLayer` per layer.  The
    parameters are uninitialised: :func:`init_params` or
    :func:`params_from_numpy` fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _dense_only(cfg)
        dt = dtype_of(cfg.param_dtype)
        d, v = cfg.d_model, cfg.vocab_size
        top = {"embed": ((v, d), None), "final_norm": ((d,), None)}
        if not cfg.tie_embeddings:
            top["lm_head"] = ((d, v), None)
        register_params(self, top, dt, device)
        self.layers = torch.nn.ModuleList(
            DecoderLayer(cfg, dt, device) for _ in range(cfg.n_layers))
        self.cfg = cfg


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> DenseLM:
    """Random weights by the reference's rules (``model.py:80-100``): 1-D
    parameters (norm scales, biases) start at 0; matrices are standard
    normal times ``1/sqrt(fan_in)``, ``fan_in = shape[-2]`` of the
    unstacked matrix.  The draws come from ``generator``, which must live
    on ``device``; they are not the reference's ``jax.random`` numbers."""
    model = DenseLM(cfg, device)
    for p in model.parameters():
        if p.dim() <= 1:
            p.zero_()
        else:
            p.normal_(generator=generator).mul_(1.0 / np.sqrt(
                max(p.shape[-2], 1)))
    return model


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> DenseLM:
    """A :class:`DenseLM` holding the reference's parameter tree ``tree``
    (numpy arrays, layer arrays stacked over L, as ``jax.device_get`` of
    ``repro.models.model.init_params`` gives it).  Refuses a tree whose keys
    or shapes differ from :func:`param_specs`."""
    want = _flat(param_specs(cfg))
    got = {k: np.asarray(a) for k, a in _flat(tree).items()}
    if set(got) != set(want):
        raise ValueError(f"parameter tree keys differ from param_specs: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    bad = {k: (got[k].shape, want[k]) for k in want
           if tuple(got[k].shape) != tuple(want[k])}
    if bad:
        raise ValueError(f"parameter shapes differ from param_specs "
                         f"(got, want): {bad}")
    model = DenseLM(cfg, device)
    own = dict(model.named_parameters())
    for i in range(cfg.n_layers):
        for k, a in _flat(_tree_at(tree["layers"], i), f"layers.{i}.").items():
            own[k].copy_(torch.from_numpy(np.array(a)))
    for k in ("embed", "lm_head", "final_norm"):
        if k in own:
            own[k].copy_(torch.from_numpy(np.array(tree[k])))
    return model


def numpy_from_params(model: DenseLM) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's tree of
    numpy arrays, layer arrays stacked over L."""
    per = [{k: v.detach().cpu().numpy() for k, v in layer.named_parameters()}
           for layer in model.layers]
    tree: dict = {}
    for k in per[0]:
        node = tree
        *path, leaf = k.split(".")
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = np.stack([p[k] for p in per])
    tree = {"layers": tree}
    for k, v in model.named_parameters():
        if not k.startswith("layers."):
            tree[k] = v.detach().cpu().numpy()
    return tree


def _head(cfg: ModelConfig, model: DenseLM, x: torch.Tensor) -> torch.Tensor:
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (x @ w.to(x.dtype)).float()
    return softcap(logits, cfg.logit_softcap)
