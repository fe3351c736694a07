"""Mesh placement of the stacked shard pools — the port of
``src/repro/parallel/index_placement.py`` (DESIGN.md §13).

The ``(S, ...)`` pools of ``core.lookup.stacked_device_arrays`` are
layout-ready for a 1-D device mesh: the leading shard axis maps to the mesh
axis ``'shards'`` (``INDEX_RULES``), so mesh position ``d`` holds only the
rows ``[d*Sl, (d+1)*Sl)`` of each pool (``Sl = S // D``).  Everything a
query needs *before* it knows its owning position stays replicated:

* ``bounds`` — the boundary table: every position routes the batch and
  decides ownership itself;
* ``leaf_next_chain`` — the cross-shard successor chain: a scan that
  crosses a shard boundary continues in the next position's pools, so
  every position walks the chain and contributes only its own rows;
* the overlay pack (``ov_pack``) and the query batch.

A placed stack is the same dict with every array field turned into a tuple
of ``D`` tensors, one a position, each moved with ``.to(device)``: a
pool's row slice, or a replicated field's copy on the position's device
(one copy a distinct device).  On a device that already holds the tensor
``.to`` returns it (a row slice is a view), so a mesh that names one card
``D`` times holds the stack once, whether it was built there or on the
host.
A pool whose shard axis does not divide the mesh is replicated (the
reference's ``spec_for`` fallback); the read path refuses such a stack
(:func:`mesh_local_shards`), and the engine pads its shard slots to
a device multiple so it never builds one.
"""
from __future__ import annotations

from typing import Optional

from .sharding import INDEX_RULES, DeviceMesh, index_mesh, spec_for

__all__ = ["MESH_AXIS", "REPLICATED_FIELDS", "index_mesh",
           "mesh_num_devices", "mesh_local_shards", "stacked_spec",
           "place_stacked", "place_overlay_pack"]

MESH_AXIS = "shards"

# Operand-dict fields every position needs in full (module docstring); any
# non-tensor leaf (bounds_version, n_live) passes through as is.
REPLICATED_FIELDS = frozenset({"bounds", "leaf_next_chain", "ov_pack"})


def mesh_num_devices(mesh: Optional[DeviceMesh]) -> int:
    """Positions along the index mesh's shard axis (0 = no mesh)."""
    if mesh is None:
        return 0
    return int(mesh.shape[MESH_AXIS])


def mesh_local_shards(S: int, mesh) -> int:
    """Shards a position holds; the stack's padded slot count must divide
    the mesh (the engine pads its shard slots to a device multiple: refuse
    loudly instead of serving from a silently replicated layout)."""
    D = mesh_num_devices(mesh)
    if S % D:
        raise ValueError(
            f"stacked shard slots S={S} not divisible by the index mesh's "
            f"{D} devices — pad shard slots to a device multiple")
    return S // D


def stacked_spec(name: str, shape, mesh) -> tuple:
    """Spec tuple of one stacked-operand field: leading shard axis mapped
    through ``INDEX_RULES`` (with ``spec_for``'s divisibility fallback),
    trailing axes replicated; ``REPLICATED_FIELDS`` fully replicated."""
    if name in REPLICATED_FIELDS:
        return ()
    axes = (MESH_AXIS,) + (None,) * (len(shape) - 1)
    return spec_for(shape, axes, mesh, INDEX_RULES)


def place_stacked(stk: dict, mesh: DeviceMesh) -> dict:
    """Place a ``stacked_device_arrays`` dict (or any subset of its fields)
    on the index mesh: every ``(S, ...)`` pool as one row slice a position,
    ``REPLICATED_FIELDS`` (and pools the mesh does not divide) whole on
    every position, non-tensor leaves untouched."""
    D = mesh_num_devices(mesh)
    out = {}
    for name, v in stk.items():
        if not hasattr(v, "shape") or v.dim() < 1:
            out[name] = v
        elif stacked_spec(name, tuple(v.shape), mesh)[:1] == (MESH_AXIS,):
            n = v.shape[0] // D
            out[name] = tuple(v[d * n:(d + 1) * n].to(dev)
                              for d, dev in enumerate(mesh.devices))
        else:
            # one copy a distinct device, shared by its positions
            copies = {dev: v.to(dev) for dev in mesh.distinct_devices()}
            out[name] = tuple(copies[dev] for dev in mesh.devices)
    return out


def place_overlay_pack(ovr: dict, mesh: DeviceMesh) -> dict:
    """Commit an overlay dict to replicated mesh placement: its pack on the
    mesh's first device (where the port's reads merge the overlay, after
    the gather) and, in ``ov_replicas``, an overlay dict on each other
    distinct device.  The engine merges every step's writes into each of
    them (DESIGN.md §14), so a pack is placed once, at a reseed."""
    first, *rest = mesh.distinct_devices()
    fill = ovr.get("ov_fill", ovr["ov_pack"].shape[1])
    out = dict(ovr)
    out["ov_pack"] = ovr["ov_pack"].to(first)
    out["ov_replicas"] = tuple({"ov_pack": ovr["ov_pack"].to(dev),
                                "ov_fill": fill} for dev in rest)
    return out
