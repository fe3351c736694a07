"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version in its ``ops.py`` (the CUDA sources live in ``../csrc``):

* ``fused_lookup``  (K1) — the batched point read, over one mirror or (with
  its shard route, ``fused_lookup_sharded``) over stacked shard mirrors,
  launched once a position on an index mesh
  (``fused_lookup.ops.fused_lookup_sharded_mesh``);
* ``overlay_merge`` (K2) — the write batch's merge into the overlay pack
  (its per-shard-row form, ``overlay_merge.ops.overlay_merge_stacked``,
  and that form's mesh twin have no caller in the engines, as in the
  reference);
* ``overlay_probe`` (K3) — the overlay's verdict per query;
* ``leaf_search``   (K4) — one row's rank search per query;
* ``inner_probe``   (K5) — one inner-level resolve per query, and the staged
  block-at-a-time read ``inner_probe_lookup`` built from K5 and K4;
* ``paged_attention`` (K6) — one GQA decode step over the paged KV pool.

Importing this package builds nothing: a kernel is compiled at its first
launch (``_build``)."""
from .fused_lookup.ops import (fused_lookup, fused_lookup_sharded,
                               lookup_plain, lookup_sharded_plain)
from .inner_probe.ops import ProbeIndex, inner_probe_lookup
from .leaf_search.ops import leaf_search
from .overlay_merge.ops import merge_overlay_pack_torch, overlay_merge
from .overlay_probe.ops import overlay_probe
from .paged_attention.ops import paged_attention, paged_attention_plain

__all__ = ["fused_lookup", "fused_lookup_sharded", "lookup_plain",
           "lookup_sharded_plain", "merge_overlay_pack_torch",
           "overlay_merge", "ProbeIndex", "inner_probe_lookup",
           "leaf_search", "overlay_probe", "paged_attention",
           "paged_attention_plain"]
