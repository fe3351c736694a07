"""Meshes for the LM's sharding rules — the port of
``src/repro/launch/mesh.py`` (functions, not module constants: importing
this module touches no device).

:func:`make_host_mesh` names real torch devices (every CUDA device by
default; a device may repeat, as ``[cuda:0] * 4`` on one card).
:func:`make_production_mesh` is the reference's TPU pod shapes on the meta
device, for the dry-run (``launch.dryrun``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..parallel.sharding import DeviceMesh, mesh_devices


def _shape(data: int, model: int, pod: int) -> dict:
    return ({"pod": pod, "data": data, "model": model} if pod
            else {"data": data, "model": model})


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The reference's production shapes: 16x16 ``(data, model)`` = 256
    chips a pod, 2x16x16 ``(pod, data, model)`` = 512 multi-pod.  These are
    TPU pod shapes, kept so that the specs the rules give can be compared
    with the reference's; they are not a GPU cluster.  Every position is
    ``torch.device("meta")``: the mesh has a shape and no devices."""
    shape = _shape(16, 16, 2 if multi_pod else 0)
    return DeviceMesh(shape, (torch.device("meta"),) * math.prod(
        shape.values()))


def make_host_mesh(data: int = 1, model: int = 1, pod: int = 0,
                   devices: Optional[Sequence] = None) -> DeviceMesh:
    """A small ``(data, model)`` mesh, or ``(pod, data, model)`` with
    ``pod``, over the first ``pod*data*model`` of ``devices``.  ``devices``
    defaults to every CUDA device and raises without CUDA
    (``parallel.sharding.mesh_devices``, as ``index_mesh``); a device may
    be named more than once, and then the mesh adds no memory."""
    shape = _shape(data, model, pod)
    devices = mesh_devices(devices)
    n = math.prod(shape.values())
    if n > len(devices):
        raise ValueError(f"make_host_mesh: {len(devices)} devices, a mesh "
                         f"of shape {shape} needs {n}")
    return DeviceMesh(shape, tuple(devices[:n]))
