"""The index side of logical-axis sharding — the port of
``src/repro/parallel/sharding.py`` (``INDEX_RULES``, ``_usable``,
``spec_for``, ``index_mesh``; DESIGN.md §13).

A rule table maps a tensor's logical axes to mesh axes; :func:`spec_for`
resolves one tensor's axes with the reference's divisibility and no-reuse
checks.  A spec is a plain tuple of mesh axis names (or ``None``), one
entry a dimension: the reference's ``PartitionSpec`` as a tuple.

:func:`index_mesh` returns an :class:`IndexMesh`, the 1-D device mesh the
stacked shard pools are placed on (``index_placement``).  Its devices are
torch devices, and one may appear more than once: a mesh of one card named
D times is the stand-in for the reference's forced host devices
(``--xla_force_host_platform_device_count``).  It exercises the routing,
the per-position launches and the installs on the owning position, not
copies between cards or launches on several cards at once.

The LM side of the module (``PARAM_RULES``, ``ACT_RULES``,
``ShardingContext``, ``shard_acts``) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from ..device import resolve

AxisSpec = Union[str, tuple, None]

# The learned-index serving side (DESIGN.md §13): the stacked (S, ...) shard
# pools shard their leading shard axis across a 1-D index mesh; everything
# else (boundary table, overlay pack, queries) stays replicated.
INDEX_RULES: dict[str, AxisSpec] = {
    "shards": "shards",
}


@dataclasses.dataclass(frozen=True)
class IndexMesh:
    """A 1-D mesh of torch devices along the axis ``"shards"``: position
    ``d`` holds the ``d``-th slice of every stacked pool."""
    devices: tuple

    axis_names = ("shards",)

    @property
    def shape(self) -> dict:
        return {"shards": len(self.devices)}

    def distinct_devices(self) -> list:
        """The mesh's devices, each once, in order of first position."""
        return list(dict.fromkeys(self.devices))


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


def index_mesh(n_devices: Optional[int] = None, *,
               devices: Optional[Sequence] = None) -> IndexMesh:
    """1-D device mesh for stacked-shard-pool placement (axis ``'shards'``,
    DESIGN.md §13).  ``devices`` defaults to every CUDA device (raising
    without CUDA, as ``device.resolve`` does); a device may be named more
    than once (module docstring).  ``n_devices`` takes a prefix of them."""
    if devices is None:
        first = resolve(None)       # cuda:0, or raises
        devices = [first] + [torch.device("cuda", i)
                             for i in range(1, torch.cuda.device_count())]
    devices = [resolve(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(
                f"index_mesh: n_devices={n_devices} outside "
                f"[1, {len(devices)}] available devices")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("index_mesh: no devices")
    return IndexMesh(tuple(devices))
