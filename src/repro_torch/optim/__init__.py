"""Optimizer substrate of the port: AdamW + global-norm clipping +
schedules + optional error-feedback gradient compression."""
from .adamw import (AdamWConfig, adamw_init, adamw_update, clip_by_global_norm,
                    cosine_schedule, opt_state_specs)
from .compress import compress_grads, compressor_init

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "opt_state_specs", "compress_grads",
           "compressor_init"]
