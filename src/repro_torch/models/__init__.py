"""The LM substrate of the port: every family's parameters and layers
(dense, moe, ssm, hybrid, audio, vlm), as ``nn.Module``s whose parameter
names equal the reference's keys, and their contiguous-cache forward,
prefill and decode steps (``model``)."""
from .model import (DenseLM, init_params, numpy_from_params, param_specs,
                    params_from_numpy)

__all__ = ["DenseLM", "init_params", "numpy_from_params", "param_specs",
           "params_from_numpy"]
