"""Parallelism substrate of the port: the LM's logical-axis sharding rules
and context, the index mesh and the placement of the stacked shard pools
on it (DESIGN.md §13)."""
from .index_placement import (MESH_AXIS, REPLICATED_FIELDS, mesh_local_shards,
                              mesh_num_devices, place_overlay_pack,
                              place_stacked, stacked_spec)
from .sharding import (ACT_RULES, INDEX_RULES, PARAM_RULES, DeviceMesh,
                       NamedSharding, ShardingContext, current_mesh,
                       get_context, index_mesh, installed, mesh_devices,
                       named_sharding, set_context, shard_acts, spec_for)

__all__ = ["ACT_RULES", "DeviceMesh", "INDEX_RULES", "MESH_AXIS",
           "NamedSharding", "PARAM_RULES", "REPLICATED_FIELDS",
           "ShardingContext", "current_mesh", "get_context", "index_mesh",
           "installed", "mesh_devices", "mesh_local_shards",
           "mesh_num_devices", "named_sharding", "place_overlay_pack",
           "place_stacked", "set_context", "shard_acts", "spec_for",
           "stacked_spec"]
