"""Error-feedback gradient compression (int8 per-tensor-row scales) — port
of ``src/repro/optim/compress.py``.

Gradients are quantized to int8 with an error-feedback residual so the
quantization error is re-injected next step (Seide et al. '14 / EF-SGD):
q = quant(g + e); e' = (g + e) - dequant(q).  As in the reference, nothing
on the train step calls it: it is the building block a bandwidth-bound
cross-host reduction would use.
"""
from __future__ import annotations

import torch

from ..tree import leaves, tree_map, unflatten


def compressor_init(params):
    """Per-parameter error-feedback residuals (float32, on each leaf's
    device)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_dequant(x: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantize-dequantize over the last axis."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q * scale


@torch.no_grad()
def compress_grads(grads, residuals):
    """Returns (dequantized grads as seen post-allreduce, new residuals)."""

    def one(g, e):
        corrected = g.float() + e
        dq = _quant_dequant(corrected)
        return dq.to(g.dtype), corrected - dq

    gs, es = leaves(grads), leaves(residuals)
    if len(gs) != len(es):
        raise ValueError("grads and residuals differ in structure")
    out = [one(g, e) for g, e in zip(gs, es)]
    return (unflatten(grads, iter([o[0] for o in out])),
            unflatten(grads, iter([o[1] for o in out])))
