"""Model assembly of the dense and moe families: parameter specs, the
``DenseLM`` module, its initialisation, the carry-over of the reference's
parameter tree, the KV cache specs, and the full-sequence forward, prefill
and decode steps over a contiguous cache — port of
``src/repro/models/model.py:48-110, 120-134, 155-235``.

Parameter names equal the reference's keys (``layers.3.attn.wq`` is row 3
of the reference's ``params["layers"]["attn"]["wq"]``, ``layers.0.ffn.
shared_w_up`` row 0 of its ``["ffn"]["shared_w_up"]``) and matrices keep
its (in, out) orientation.

``forward``, ``prefill`` and ``decode_step`` run on ``cuda:0`` unless the
caller passes ``device`` (``"cpu"`` for the plain path); they raise when
CUDA is absent, or when the model or cache lives elsewhere.  Token and
position inputs may be numpy arrays or tensors.  The loss, the dry-run
specs (``Spec``, ``input_specs``) and the recurrent families' state come
later (ROADMAP Queue 1 items 9.5, 9.6 and 9.8).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve
from .attention import kv_cache_specs
from .common import dtype_of, register_params, rms_norm, softcap
from .transformer import (DecoderLayer, _tree_at, check_family,
                          layer_param_specs, n_attn_layers, stack_decode,
                          stack_forward)


def param_specs(cfg: ModelConfig) -> dict:
    """Nested name -> shape tuple of the reference's parameter tree (layer
    parameters stacked over a leading L axis)."""
    check_family(cfg)
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
    (D,), and ``layers``: one :class:`DecoderLayer` per layer.  It holds
    the moe family too (its layers' ``ffn`` is a :class:`MoE`).  The
    parameters are uninitialised: :func:`init_params` or
    :func:`params_from_numpy` fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_family(cfg)
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


def _from_numpy(a) -> torch.Tensor:
    """A CPU tensor of ``a``'s values.  A ``bfloat16`` array (ml_dtypes'
    type, as ``jax.device_get`` gives it) is carried bit for bit."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s values as numpy; bfloat16 (no numpy type) widens exactly to
    float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


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
            own[k].copy_(_from_numpy(a))
    for k in ("embed", "lm_head", "final_norm"):
        if k in own:
            own[k].copy_(_from_numpy(tree[k]))
    return model


def numpy_from_params(model: DenseLM) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's tree of
    numpy arrays, layer arrays stacked over L (bfloat16 parameters as their
    exact float32 values)."""
    per = [{k: _to_numpy(v) for k, v in layer.named_parameters()}
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
            tree[k] = _to_numpy(v)
    return tree


def _head(cfg: ModelConfig, model: DenseLM, x: torch.Tensor) -> torch.Tensor:
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = (x @ w.to(x.dtype)).float()
    return softcap(logits, cfg.logit_softcap)


# ------------------------------------------------------------------ caches

def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """name -> (shape, dtype) of the self-attention KV cache."""
    check_family(cfg)
    return kv_cache_specs(cfg, batch, s_max, n_attn_layers(cfg))


def init_zeros(specs: dict, device=None) -> dict:
    """Zero tensors for a ``name -> (shape, dtype)`` dict, on ``device``
    (``cuda:0`` unless named)."""
    dev = resolve(device)
    return {k: torch.zeros(shape, dtype=dtype_of(dt), device=dev)
            for k, (shape, dt) in specs.items()}


# ------------------------------------------------------------------ forward

def _on(model: DenseLM, cache: Optional[dict], device) -> torch.device:
    """The device a step runs on; the model and cache must live there."""
    dev = resolve(device)
    held = [("model", model.embed)] + [
        (f"cache[{k!r}]", t) for k, t in (cache or {}).items()]
    for name, t in held:
        if t.device != dev:
            raise ValueError(f"the {name} lives on {t.device}, the step "
                             f"runs on {dev}")
    return dev


def _ids(a, dev: torch.device) -> torch.Tensor:
    """Integer token ids or positions (numpy or tensor) on ``dev``."""
    return torch.as_tensor(a, device=dev).long()


def _embed_in(cfg: ModelConfig, model: DenseLM, batch: dict,
              dev: torch.device) -> torch.Tensor:
    """Token embeddings in the compute dtype, scaled by sqrt(d_model)
    rounded to that dtype first (gemma2); the audio family's frame inputs
    come with that family."""
    cdt = dtype_of(cfg.compute_dtype)
    x = model.embed[_ids(batch["tokens"], dev)].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cdt)
    return x


def forward(cfg: ModelConfig, model: DenseLM, batch: dict,
            cache: Optional[dict] = None, *, device=None):
    """Full-sequence forward over ``batch["tokens"]`` (B,S).  Returns
    (hidden (B,S,D), aux, cache); a given ``cache`` is filled in place."""
    dev = _on(model, cache, device)
    x = _embed_in(cfg, model, batch, dev)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=dev
                             )[None].expand(B, S)
    x, aux, cache = stack_forward(cfg, model.layers, x, positions,
                                  cache=cache)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, aux, cache


@torch.no_grad()
def prefill(cfg: ModelConfig, model: DenseLM, batch: dict, cache: dict, *,
            device=None):
    """Fill the KV cache (in place) from a full prompt; logits (B,V) float32
    for the LAST position only (the slice comes before the head)."""
    x, _, cache = forward(cfg, model, batch, cache=cache, device=device)
    logits = _head(cfg, model, x[:, -1:])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: DenseLM, tokens, pos,
                cache: Optional[dict], state: Optional[dict], *,
                device=None):
    """One decode step. tokens (B,1) integer, pos (B,) integer.

    Returns (logits (B,V) float32, next_token (B,) int32, cache, state);
    the cache is written at ``pos`` in place."""
    dev = _on(model, cache, device)
    x = _embed_in(cfg, model, {"tokens": tokens}, dev)
    x, cache, state = stack_decode(cfg, model.layers, x, _ids(pos, dev),
                                   cache=cache, state=state)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head(cfg, model, x)[:, 0]
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, next_tok, cache, state
