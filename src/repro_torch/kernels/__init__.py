"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in its ``ops.py`` (the CUDA sources live in ``../csrc``):

* ``fused_lookup``  (K1) — the batched point read;
* ``overlay_merge`` (K2) — the write batch's merge into the overlay pack.

Importing this package builds nothing: a kernel is compiled at its first
launch (``_build``)."""
from .fused_lookup.ops import fused_lookup, lookup_plain
from .overlay_merge.ops import merge_overlay_pack_torch, overlay_merge

__all__ = ["fused_lookup", "lookup_plain", "merge_overlay_pack_torch",
           "overlay_merge"]
