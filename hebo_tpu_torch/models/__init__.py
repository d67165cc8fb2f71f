from . import gp  # noqa: F401  (registers "gp")
from . import linreg  # noqa: F401  (registers "lin_reg")
from .base import BaseModel, MultiTaskModel, get_model, get_model_class, register_model

__all__ = ["BaseModel", "MultiTaskModel", "get_model", "get_model_class", "register_model"]
