"""Model assembly of every family: parameter specs, the ``DenseLM``
module, its initialisation, the carry-over of the reference's parameter
tree, the KV cache and recurrent-state specs, the full-sequence forward,
the training loss, the prefill and decode steps over a contiguous cache,
and the input specs — port of ``src/repro/models/model.py``.

Parameter names equal the reference's keys (``layers.3.attn.wq`` is row 3
of the reference's ``params["layers"]["attn"]["wq"]``, ``layers.0.tm.wr``
row 0 of its ``["layers"]["tm"]["wr"]``, ``extras.shared_attn.attn.wq``
its ``["extras"]["shared_attn"]["attn"]["wq"]`` and ``extras.cross.1.attn.
wk`` row 1 of its ``["extras"]["cross"]["attn"]["wk"]``) and matrices keep
its (in, out) orientation.

``forward``, ``prefill`` and ``decode_step`` run on ``cuda:0`` unless the
caller passes ``device`` (``"cpu"`` for the plain path); they raise when
CUDA is absent, or when the model, cache or state lives elsewhere.  Token
and position inputs may be numpy arrays or tensors; so may the audio
family's ``frames`` and the vlm's ``patches`` (B, P, D), which are cast to
the compute dtype.  The audio family prefills from frames and decodes
token ids through its embedding table, as in the reference.  ``loss_fn``
is the training loss (the train step differentiates it, also on the card
unless ``device`` names another); ``input_specs`` and ``param_spec_tree``
give the reference's ``Spec`` trees (shape, dtype, logical axes) of a
step's inputs and of the parameters, and ``spec_tree_to_meta`` a tree of
them as meta tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..configs.base import SHAPES, ModelConfig, ShapeConfig
from ..device import resolve
from ..tree import leaf_tensor, tree_map
from .attention import kv_cache_specs
from .common import (cotangent_cast, cross_entropy, dtype_of,
                     register_params, rms_norm, softcap)
from .mamba2 import mamba_state_specs
from .rwkv6 import rwkv_state_specs
from .transformer import (_tree_at, extra_param_specs, layer_param_specs,
                          make_extras, make_layer, n_attn_layers,
                          n_cross_layers, stack_decode, stack_forward)


@dataclasses.dataclass(frozen=True)
class Spec:
    """Shape + dtype + logical axes for one tensor."""
    shape: tuple
    dtype: str
    axes: tuple


def _spec_tree(specs: dict, dtype: str, lead: tuple = (),
               lead_axes: tuple = ()) -> dict:
    """A nested ``name -> (shape, logical_axes)`` dict as ``name -> Spec``
    with ``lead`` / ``lead_axes`` put in front."""
    return {k: _spec_tree(s, dtype, lead, lead_axes) if isinstance(s, dict)
            else Spec(lead + tuple(s[0]), dtype, lead_axes + tuple(s[1]))
            for k, s in specs.items()}


def param_spec_tree(cfg: ModelConfig) -> dict:
    """The reference's ``param_specs``: the parameter tree as ``Spec``
    leaves, layer parameters stacked over a leading L axis ("layers"), the
    vlm's cross layers over n_cross_layers."""
    d, v, dt = cfg.d_model, cfg.vocab_size, cfg.param_dtype
    out: dict = {"embed": Spec((v, d), dt, ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["lm_head"] = Spec((d, v), dt, ("embed", "vocab"))
    out["final_norm"] = Spec((d,), dt, (None,))
    out["layers"] = _spec_tree(layer_param_specs(cfg), dt, (cfg.n_layers,),
                               ("layers",))
    extras = extra_param_specs(cfg)
    if extras:
        out["extras"] = _spec_tree(extras, dt)
    return out


def param_specs(cfg: ModelConfig) -> dict:
    """Nested name -> shape tuple of the reference's parameter tree (the
    shapes of :func:`param_spec_tree`)."""
    return tree_map(lambda s: s.shape, param_spec_tree(cfg))


def spec_tree_to_meta(specs) -> dict:
    """A ``Spec`` tree as tensors on the meta device (shape and dtype, no
    storage): the reference's ``spec_tree_to_sds``, for the dry-run."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=getattr(torch,
                                                                 s.dtype),
                                          device="meta"), specs)


class DenseLM(torch.nn.Module):
    """The model of any family: ``embed`` (V, D), ``lm_head`` (D, V) unless
    tied, ``final_norm`` (D,), ``layers`` (one layer module per layer:
    :class:`~.transformer.DecoderLayer` for the dense, moe, audio and vlm
    families, :class:`~.transformer.RWKVLayer` for ssm,
    :class:`~.transformer.MambaLayer` for hybrid) and ``extras`` (zamba2's
    ``shared_attn``, the vlm's ``cross`` layers; empty otherwise).  The
    parameters are uninitialised: :func:`init_params` or
    :func:`params_from_numpy` fills them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d, v = cfg.d_model, cfg.vocab_size
        top = {"embed": ((v, d), None), "final_norm": ((d,), None)}
        if not cfg.tie_embeddings:
            top["lm_head"] = ((d, v), None)
        register_params(self, top, dt, device)
        self.layers = torch.nn.ModuleList(
            make_layer(cfg, dt, device) for _ in range(cfg.n_layers))
        self.extras = make_extras(cfg, dt, device)
        self.cfg = cfg


def _ref_shape(cfg: ModelConfig, name: str, shape: tuple) -> tuple:
    """The shape of the reference's leaf that holds parameter ``name``:
    layer parameters stacked over L, cross-layer ones over n_cross."""
    if name.startswith("layers."):
        return (cfg.n_layers,) + shape
    if name.startswith("extras.cross."):
        return (n_cross_layers(cfg),) + shape
    return shape


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> DenseLM:
    """Random weights by the reference's rules (``_init_leaf``,
    ``model.py:80-100``), applied as there to the shape of the reference's
    leaf (:func:`_ref_shape`): a 1-D leaf, or a leaf named ``b*``,
    ``mix*`` or ``cmix*``, is a constant (``A_log`` log(linspace(1, 16)),
    ``w_base`` -2, ``D``, ``u``, ``mix*`` and ``cmix*`` 0.5, else 0); any
    other is standard normal times ``1/sqrt(shape[-2])``.  So stacked layer
    vectors (norm scales, ``A_log``, ``w_base``, ``u``, ``D``) are random
    with fan-in L, and only the top-level ``final_norm`` and zamba2's
    shared ``ln`` start at 0.  The draws come from ``generator``, which must
    live on ``device``; they are not the reference's ``jax.random``
    numbers."""
    model = DenseLM(cfg, device)
    for name, p in model.named_parameters():
        shape = _ref_shape(cfg, name, tuple(p.shape))
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) <= 1 or leaf.startswith(("b", "mix", "cmix")):
            if leaf == "A_log":   # mamba: A in [-16, -1]
                p.copy_(torch.log(torch.linspace(1.0, 16.0, shape[-1]))
                        .to(p.dtype).expand(p.shape))
            elif leaf == "w_base":   # rwkv decay base: exp(-exp(-2)) ~ 0.87
                p.fill_(-2.0)
            elif leaf in ("D", "u") or leaf.startswith(("mix", "cmix")):
                p.fill_(0.5)
            else:
                p.zero_()
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[0]
            p.normal_(generator=generator).mul_(1.0 / np.sqrt(max(fan_in,
                                                                  1)))
    return model


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """``t``'s values as numpy; bfloat16 widens exactly to float32, so
    that the tree feeds numpy and ``jnp`` code, which take no void arrays
    (a checkpoint keeps the bits instead: ``tree.leaf_numpy``)."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _rows(tree: dict, n: int, prefix: str) -> dict:
    """Row i < n of every array of a stacked tree, flat under
    ``{prefix}{i}.``."""
    out = {}
    for i in range(n):
        out.update(_flat(_tree_at(tree, i), f"{prefix}{i}."))
    return out


def flat_arrays(cfg: ModelConfig, tree: dict) -> dict:
    """The reference's parameter tree ``tree`` (arrays, layer arrays
    stacked over L and cross-layer arrays over n_cross) as ``name ->
    array``, one entry per parameter of :class:`DenseLM` (row i of a
    stacked leaf under ``layers.{i}.``).  Refuses a tree whose keys or
    shapes differ from :func:`param_specs`.  The optimizer's moments,
    which mirror the parameters, go through it too."""
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
    arrays = _rows(tree["layers"], cfg.n_layers, "layers.")
    extras = tree.get("extras", {})
    if "shared_attn" in extras:
        arrays.update(_flat(extras["shared_attn"], "extras.shared_attn."))
    if "cross" in extras:
        arrays.update(_rows(extras["cross"], n_cross_layers(cfg),
                            "extras.cross."))
    arrays.update({k: tree[k] for k in ("embed", "lm_head", "final_norm")
                   if k in tree})
    return arrays


@torch.no_grad()
def params_from_numpy(cfg: ModelConfig, tree: dict, device) -> DenseLM:
    """A :class:`DenseLM` holding the reference's parameter tree ``tree``
    (numpy arrays, as ``jax.device_get`` of
    ``repro.models.model.init_params`` gives it; see
    :func:`flat_arrays`)."""
    arrays = flat_arrays(cfg, tree)
    model = DenseLM(cfg, device)
    for k, p in model.named_parameters():
        p.copy_(leaf_tensor(arrays[k]))
    return model


def _nest(flat: dict) -> dict:
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *path, leaf = k.split(".")
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = v
    return tree


def stacked_tree(cfg: ModelConfig, flat: dict) -> dict:
    """The inverse of :func:`flat_arrays`: ``name -> numpy array``, one
    entry per parameter, as the reference's tree (layer arrays stacked
    over L, cross-layer arrays over n_cross)."""
    def rows(prefix: str, n: int) -> dict:
        per = [{k[len(f"{prefix}{i}."):]: v for k, v in flat.items()
                if k.startswith(f"{prefix}{i}.")} for i in range(n)]
        return _nest({k: np.stack([p[k] for p in per]) for k in per[0]})

    tree = {"layers": rows("layers.", cfg.n_layers)}
    extras = {}
    if cfg.shared_attn_period:
        pre = "extras.shared_attn."
        extras["shared_attn"] = _nest({k[len(pre):]: v for k, v in
                                       flat.items() if k.startswith(pre)})
    if n_cross_layers(cfg):
        extras["cross"] = rows("extras.cross.", n_cross_layers(cfg))
    if extras:
        tree["extras"] = extras
    tree.update({k: flat[k] for k in ("embed", "lm_head", "final_norm")
                 if k in flat})
    return tree


def numpy_from_params(model: DenseLM) -> dict:
    """The inverse of :func:`params_from_numpy`: the reference's tree of
    numpy arrays, bfloat16 parameters as their exact float32 values (the
    tests feed it to the reference; ``runtime.driver.checkpoint_tree``
    gives the bits form a checkpoint stores)."""
    return stacked_tree(model.cfg, {k: _to_numpy(v)
                                    for k, v in model.named_parameters()})


def _head(cfg: ModelConfig, model: DenseLM, x: torch.Tensor) -> torch.Tensor:
    w = model.embed.T if cfg.tie_embeddings else model.lm_head
    x = cotangent_cast(x)  # keep the backward residual stream in x's dtype
    logits = (x @ w.to(x.dtype)).float()
    return softcap(logits, cfg.logit_softcap)


# ------------------------------------------------------------------ caches

def cache_specs(cfg: ModelConfig, batch: int, s_max: int) -> dict:
    """name -> (shape, dtype) of the self-attention KV cache, plus the
    vlm's cross k/v (``xk``, ``xv``: (n_cross, B, n_patches, Hkv, Dh) in the
    compute dtype).  Empty for the ssm family."""
    na = n_attn_layers(cfg)
    out = kv_cache_specs(cfg, batch, s_max, na) if na else {}
    nc = n_cross_layers(cfg)
    if nc:
        shape = (nc, batch, cfg.n_patches, cfg.n_kv_heads, cfg.head_dim_)
        out["xk"] = (shape, cfg.compute_dtype)
        out["xv"] = (shape, cfg.compute_dtype)
    return out


def state_specs(cfg: ModelConfig, batch: int) -> dict:
    """name -> (shape, dtype) of the recurrent state: ``ssm`` and ``conv``
    (hybrid), ``wkv``, ``tshift_t`` and ``tshift_c`` (ssm); empty for the
    other families."""
    if cfg.family == "hybrid":
        return mamba_state_specs(cfg, batch, cfg.n_layers)
    if cfg.family == "ssm":
        return rwkv_state_specs(cfg, batch, cfg.n_layers)
    return {}


def init_zeros(specs: dict, device=None) -> dict:
    """Zero tensors for a ``name -> (shape, dtype)`` dict, on ``device``
    (``cuda:0`` unless named)."""
    dev = resolve(device)
    return {k: torch.zeros(shape, dtype=dtype_of(dt), device=dev)
            for k, (shape, dt) in specs.items()}


# ------------------------------------------------------------------ forward

def _on(model: DenseLM, cache: Optional[dict], device,
        state: Optional[dict] = None) -> torch.device:
    """The device a step runs on; the model, cache and state must live
    there."""
    dev = resolve(device)
    held = [("model", model.embed)] + [
        (f"cache[{k!r}]", t) for k, t in (cache or {}).items()] + [
        (f"state[{k!r}]", t) for k, t in (state or {}).items()]
    for name, t in held:
        if t.device != dev:
            raise ValueError(f"the {name} lives on {t.device}, the step "
                             f"runs on {dev}")
    return dev


def _ids(a, dev: torch.device) -> torch.Tensor:
    """Integer token ids or positions (numpy or tensor) on ``dev``."""
    return torch.as_tensor(a, device=dev).long()


def _floats(a, dev: torch.device) -> torch.Tensor:
    """Frame or patch embeddings (numpy, bfloat16 numpy included, or a
    tensor) on ``dev``."""
    return (a if isinstance(a, torch.Tensor)
            else leaf_tensor(np.array(a))).to(dev)


def _embed(cfg: ModelConfig, model: DenseLM, tokens,
           dev: torch.device) -> torch.Tensor:
    """Token embeddings in the compute dtype, scaled by sqrt(d_model)
    rounded to that dtype first (gemma2)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = model.embed[_ids(tokens, dev)].to(cdt)
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cdt)
    return x


def _embed_in(cfg: ModelConfig, model: DenseLM, batch: dict,
              dev: torch.device) -> torch.Tensor:
    """The stack's input: ``batch["frames"]`` (B,S,D) cast to the compute
    dtype for the audio stub, else the embeddings of ``batch["tokens"]``."""
    if cfg.frontend_stub and cfg.family == "audio":
        cdt = dtype_of(cfg.compute_dtype)
        x = _floats(batch["frames"], dev).to(cdt)
        if cfg.embed_scale:
            x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=cdt)
    else:
        x = _embed(cfg, model, batch["tokens"], dev)
    return cotangent_cast(x)  # embed-table grads in the compute dtype


def forward(cfg: ModelConfig, model: DenseLM, batch: dict,
            cache: Optional[dict] = None, *, device=None):
    """Full-sequence forward over ``batch["tokens"]`` (B,S), or the audio
    family's ``batch["frames"]`` (B,S,D), with the vlm's
    ``batch["patches"]`` (B,P,D) as cross-attention memory.  Returns
    (hidden (B,S,D), aux, cache); a given ``cache`` is filled in place."""
    dev = _on(model, cache, device)
    x = _embed_in(cfg, model, batch, dev)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=dev
                             )[None].expand(B, S)
    memory = batch.get("patches")
    if memory is not None:
        memory = _floats(memory, dev).to(x.dtype)
    x, aux, cache = stack_forward(cfg, model.layers, x, positions,
                                  extras=model.extras, memory=memory,
                                  cache=cache)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x, aux, cache


def loss_fn(cfg: ModelConfig, model: DenseLM, batch: dict, *, device=None):
    """Mean next-token loss over ``batch["labels"]`` (B,S) (-1 is padding)
    plus, for moe, 0.01 * aux / n_layers.  Returns (loss, {"loss", "aux"}),
    float32 scalars.  The step functions differentiate it."""
    x, aux, _ = forward(cfg, model, batch, device=device)
    logits = _head(cfg, model, x)
    loss = cross_entropy(logits, _ids(batch["labels"], x.device))
    if cfg.family == "moe":
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"loss": loss, "aux": aux}


@torch.no_grad()
def prefill(cfg: ModelConfig, model: DenseLM, batch: dict, cache: dict, *,
            device=None):
    """Fill the KV cache (in place) from a full prompt; logits (B,V) float32
    for the LAST position only (the slice comes before the head).  The ssm
    and hybrid families' recurrent state is not seeded, as in the
    reference."""
    x, _, cache = forward(cfg, model, batch, cache=cache, device=device)
    logits = _head(cfg, model, x[:, -1:])
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, model: DenseLM, tokens, pos,
                cache: Optional[dict], state: Optional[dict], *,
                device=None):
    """One decode step. tokens (B,1) integer, pos (B,) integer (the audio
    family embeds its token ids too).

    Returns (logits (B,V) float32, next_token (B,) int32, cache, state);
    the cache is written at ``pos`` and the state's rows updated, in
    place."""
    dev = _on(model, cache, device, state)
    x = _embed(cfg, model, tokens, dev)
    x, cache, state = stack_decode(cfg, model.layers, x, _ids(pos, dev),
                                   extras=model.extras, cache=cache,
                                   state=state)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    logits = _head(cfg, model, x)[:, 0]
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    return logits, next_tok, cache, state


# --------------------------------------------------------------- input specs

CACHE_AXES = ("layers", "kv_batch", "kv_seq", "kv_heads", None)
SCALE_AXES = ("layers", "kv_batch", "kv_seq", "kv_heads")
# logical axes of each cache and state entry, as the reference's specs
_AXES = {"k": CACHE_AXES, "v": CACHE_AXES, "k_scale": SCALE_AXES,
         "v_scale": SCALE_AXES,
         "xk": ("layers", "kv_batch", None, "kv_heads", None),
         "xv": ("layers", "kv_batch", None, "kv_heads", None),
         "ssm": ("layers", "kv_batch", "ssm_heads", None, None),
         "conv": ("layers", "kv_batch", None, None),
         "wkv": ("layers", "kv_batch", "ssm_heads", None, None),
         "tshift_t": ("layers", "kv_batch", None),
         "tshift_c": ("layers", "kv_batch", None)}


def _with_axes(specs: dict) -> dict:
    return {k: Spec(tuple(shape), dt, _AXES[k])
            for k, (shape, dt) in specs.items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig | str) -> dict:
    """Spec tree for every *data* input of the step the shape exercises.

    train:   tokens/frames + labels (+ patches for vlm)
    prefill: tokens/frames (+ patches) + zero cache to fill
    decode:  tokens (B,1) + pos + cache/state of seq_len context
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    B, S = shape.global_batch, shape.seq_len
    d = cfg.d_model
    specs: dict = {}
    audio_stub = cfg.frontend_stub and cfg.family == "audio"
    if shape.kind in ("train", "prefill"):
        if audio_stub:
            specs["frames"] = Spec((B, S, d), cfg.compute_dtype,
                                   ("batch", None, None))
        else:
            specs["tokens"] = Spec((B, S), "int32", ("batch", None))
        if shape.kind == "train":
            specs["labels"] = Spec((B, S), "int32", ("batch", None))
        if cfg.cross_attn_period:
            specs["patches"] = Spec((B, cfg.n_patches, d), cfg.compute_dtype,
                                    ("batch", None, None))
        if shape.kind == "prefill":
            specs["cache"] = _with_axes(cache_specs(cfg, B, S))
        return specs
    # decode / long_decode: one new token against a seq_len-deep context
    specs["tokens"] = Spec((B, 1), "int32", ("batch", None))
    specs["pos"] = Spec((B,), "int32", ("batch",))
    specs["cache"] = _with_axes(cache_specs(cfg, B, S))
    specs["state"] = _with_axes(state_specs(cfg, B))
    return specs
