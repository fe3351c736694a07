"""Logical-axis sharding — the port of ``src/repro/parallel/sharding.py``
(DESIGN.md §13).

A rule table maps a tensor's logical axes to mesh axes; :func:`spec_for`
resolves one tensor's axes with the reference's divisibility and no-reuse
checks.  A spec is a plain tuple of mesh axis names (or ``None``), one
entry a dimension: the reference's ``PartitionSpec`` as a tuple.

The LM side: ``PARAM_RULES`` (weights and optimizer state: 'model' carries
heads, d_ff, vocab and experts, 'data' the weight's other large dim) and
``ACT_RULES`` (activations: 'batch' over ('pod', 'data'), 'seq' and
'kv_seq' over 'model'), a :class:`ShardingContext` (a mesh) installed per
thread (:func:`set_context`, :func:`get_context`, :func:`current_mesh`,
:func:`installed`), :func:`named_sharding` and :func:`shard_acts`.  What
runs here is the rules, the spec trees they give
(``launch.steps.shardings_for``, the dry-run's per-device bytes) and the
MoE's grouped dispatch, whose group count a context sets
(``models.moe._dispatch_groups``).  The context is per thread: the
backward of a CUDA tensor runs on autograd's own device thread, so
``models.transformer.stack_forward`` reinstalls the forward's context
around each layer it recomputes under ``cfg.remat``.  There is no GSPMD:
nothing places a tensor by its spec, and :func:`shard_acts` is the
identity.  One card cannot show the memory that sharding exists for: a
mesh of ``cuda:0`` named D times adds none, so no capacity is claimed.

A :class:`DeviceMesh` names axes over torch devices (``launch.mesh`` makes
the LM's); one device may appear more than once.  The index side:
:func:`index_mesh` returns the 1-D ``DeviceMesh`` along ``"shards"`` that
the stacked shard pools are placed on (``index_placement``).  A mesh of
one card named D times is the stand-in for the reference's forced host
devices (``--xla_force_host_platform_device_count``).  It exercises the
routing, the per-position launches and the installs on the owning
position, not copies between cards or launches on several cards at once.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import NamedTuple, Optional, Sequence, Union

import torch

from ..device import resolve

AxisSpec = Union[str, tuple, None]

# logical axis -> mesh axis (or tuple of mesh axes). Order = priority.
PARAM_RULES: dict[str, AxisSpec] = {
    "embed": "data",        # ZeRO-3: shard the non-TP weight dim over DP
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_heads": "model",
    "layers": None,
    "conv": None,
    "state": None,
}

# The learned-index serving side (DESIGN.md §13): the stacked (S, ...) shard
# pools shard their leading shard axis across a 1-D index mesh; everything
# else (boundary table, overlay pack, queries) stays replicated.
INDEX_RULES: dict[str, AxisSpec] = {
    "shards": "shards",
}

ACT_RULES: dict[str, AxisSpec] = {
    "batch": ("pod", "data"),
    "moe_group": ("pod", "data", "model"),  # fully chip-local MoE dispatch
    "seq": "model",          # sequence parallelism on the residual stream
    "kv_seq": "model",       # flash-decoding: shard long KV caches on seq
    "kv_batch": ("pod", "data"),
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "ssm_heads": "model",
    "embed": None,
    "layers": None,
}


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A mesh of torch devices with named axes: ``shape`` maps each axis
    name, in order, to its size, and ``devices`` lists the mesh's positions
    in row-major order over those axes.  A device may appear more than once
    (one card named D times); ``torch.device("meta")`` stands for devices
    that are not there (the dry-run's TPU pod shapes)."""
    shape: dict
    devices: tuple

    def __post_init__(self):
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError(f"a mesh of shape {self.shape} needs "
                             f"{math.prod(self.shape.values())} devices, "
                             f"got {len(self.devices)}")

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in order of first position."""
        return list(dict.fromkeys(self.devices))


def mesh_devices(devices: Optional[Sequence] = None) -> list:
    """``devices`` resolved to torch devices; by default every CUDA device,
    raising without CUDA as ``device.resolve`` does."""
    if devices is None:
        first = resolve(None)       # cuda:0, or raises
        devices = [first] + [torch.device("cuda", i)
                             for i in range(1, torch.cuda.device_count())]
    return [resolve(d) for d in devices]


@dataclasses.dataclass
class ShardingContext:
    mesh: DeviceMesh


_TLS = threading.local()


def set_context(ctx: Optional[ShardingContext]) -> None:
    _TLS.ctx = ctx


def get_context() -> Optional[ShardingContext]:
    return getattr(_TLS, "ctx", None)


def current_mesh() -> Optional[DeviceMesh]:
    ctx = get_context()
    return ctx.mesh if ctx is not None else None


@contextlib.contextmanager
def installed(ctx: Optional[ShardingContext]):
    """``ctx`` as this thread's context for the block, the previous one
    restored after it."""
    prev = get_context()
    set_context(ctx)
    try:
        yield ctx
    finally:
        set_context(prev)


def _usable(axis: AxisSpec, mesh, dim: int, used: set) -> Optional[tuple]:
    """Resolve one rule entry to a tuple of unused mesh axes dividing
    ``dim``."""
    if axis is None:
        return None
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    names = tuple(n for n in names if n in mesh.axis_names and n not in used)
    if not names:
        return None
    size = 1
    for n in names:
        size *= mesh.shape[n]
    # greedy prefix: drop trailing axes until the product divides the dim
    while names and dim % size != 0:
        size //= mesh.shape[names[-1]]
        names = names[:-1]
    return names if names and dim % size == 0 and size > 1 else None


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]], mesh,
             rules: dict[str, AxisSpec]) -> tuple:
    """Resolve logical ``axes`` of a tensor with ``shape`` to a spec tuple.

    Skips rules whose mesh axes are already used by an earlier dim or do
    not divide the dim, as the reference does."""
    assert len(shape) == len(axes), (shape, axes)
    used: set = set()
    parts = []
    for dim, ax in zip(shape, axes):
        rule = rules.get(ax) if ax is not None else None
        resolved = _usable(rule, mesh, int(dim), used)
        if resolved:
            used.update(resolved)
            parts.append(resolved if len(resolved) > 1 else resolved[0])
        else:
            parts.append(None)
    return tuple(parts)


class NamedSharding(NamedTuple):
    """A mesh with the spec tuple of one tensor on it: the reference's
    ``NamedSharding``, which nothing here places."""
    mesh: object
    spec: tuple


def named_sharding(shape: Sequence[int], axes: Sequence[Optional[str]],
                   mesh, *, params: bool = True) -> NamedSharding:
    """The spec of one tensor under ``PARAM_RULES`` (``params``) or
    ``ACT_RULES``."""
    rules = PARAM_RULES if params else ACT_RULES
    return NamedSharding(mesh, spec_for(shape, axes, mesh, rules))


def shard_acts(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The reference's activation annotation.  It constrains the GSPMD
    layout of ``x`` under a context; the port has no GSPMD, so it returns
    ``x`` itself, with or without a context, and the model code does not
    call it."""
    return x


def index_mesh(n_devices: Optional[int] = None, *,
               devices: Optional[Sequence] = None) -> DeviceMesh:
    """1-D device mesh for stacked-shard-pool placement (axis ``'shards'``,
    DESIGN.md §13).  ``devices`` defaults to every CUDA device
    (:func:`mesh_devices`); a device may be named more than once (module
    docstring).  ``n_devices`` takes a prefix of them."""
    devices = mesh_devices(devices)
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(
                f"index_mesh: n_devices={n_devices} outside "
                f"[1, {len(devices)}] available devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("index_mesh: no devices")
    return DeviceMesh({"shards": len(devices)}, tuple(devices))
