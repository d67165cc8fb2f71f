from . import gp  # noqa: F401  (registers "gp")
from . import linreg  # noqa: F401  (registers "lin_reg")
from .base import BaseModel, MultiTaskModel, get_model, get_model_class, register_model
from .gp import dkl, rd_gp, svgp, uncertain_gp  # noqa: F401  (register "dkl", "gp_rd", "svgp", "uncertain_gp")
from . import boosting, rf  # noqa: F401  (register "gbdt", "catboost", "rf")
from .nn import deep_ensemble, eac, ensembles_ext  # noqa: F401  (register "deep_ensemble", "eac", "mcbn",
#                                                      "gumbel", "conditional_deep_ensemble")

__all__ = ["BaseModel", "MultiTaskModel", "get_model", "get_model_class", "register_model"]
