from .convert import cache_from_jax, data_from_jax, params_from_jax
from .gp import GP, GPCache, GPCore, GPData, GPParams

__all__ = ["GP", "GPCore", "GPParams", "GPData", "GPCache", "params_from_jax", "data_from_jax",
           "cache_from_jax"]
