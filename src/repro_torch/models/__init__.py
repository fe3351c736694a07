"""The LM substrate of the port: the dense family's parameters and layers,
as ``nn.Module``s whose parameter names equal the reference's keys."""
from .model import (DenseLM, init_params, numpy_from_params, param_specs,
                    params_from_numpy)

__all__ = ["DenseLM", "init_params", "numpy_from_params", "param_specs",
           "params_from_numpy"]
