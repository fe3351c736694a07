"""Parallelism substrate of the port: the index mesh and the placement of
the stacked shard pools on it (DESIGN.md §13)."""
from .index_placement import (MESH_AXIS, REPLICATED_FIELDS, mesh_local_shards,
                              mesh_num_devices, place_overlay_pack,
                              place_stacked, stacked_spec)
from .sharding import INDEX_RULES, IndexMesh, index_mesh, spec_for

__all__ = ["INDEX_RULES", "IndexMesh", "MESH_AXIS", "REPLICATED_FIELDS",
           "index_mesh", "mesh_local_shards", "mesh_num_devices",
           "place_overlay_pack", "place_stacked", "spec_for", "stacked_spec"]
