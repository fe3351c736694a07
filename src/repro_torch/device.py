"""Explicit device resolution: the port runs on the card unless told not to.

There is no silent CPU path.  ``resolve(None)`` is ``cuda:0`` and raises
when CUDA is absent; the CPU (where every kernel wrapper runs its plain
PyTorch version) is used only when the caller asks for it by name."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` by default, else the
    named device.  Raises ``RuntimeError`` when a CUDA device is wanted and
    PyTorch sees none."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and PyTorch "
                "sees none; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
