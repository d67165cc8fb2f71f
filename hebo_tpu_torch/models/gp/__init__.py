from .convert import (cache_from_jax, data_from_jax, gp_from_jax, model_from_jax, params_from_jax,
                      svgp_from_jax)
from .gp import GP, GPCache, GPCore, GPData, GPParams, MLPKernelGP, WarpedGP

__all__ = ["GP", "WarpedGP", "MLPKernelGP", "GPCore", "GPParams", "GPData", "GPCache", "params_from_jax",
           "data_from_jax", "cache_from_jax", "gp_from_jax", "svgp_from_jax", "model_from_jax"]
