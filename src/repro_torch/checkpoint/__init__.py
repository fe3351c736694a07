"""Checkpointing of the port: sharded tree save/restore + learned manifest +
elastic restore onto torch devices + serving-partition snapshots, in the
reference's on-disk layout."""
from .ckpt import (latest_partition_step, latest_step, load_manifest,
                   load_partition, restore_checkpoint, restore_params_subset,
                   save_checkpoint, save_partition)

__all__ = ["save_checkpoint", "restore_checkpoint", "restore_params_subset",
           "load_manifest", "latest_step", "save_partition", "load_partition",
           "latest_partition_step"]
