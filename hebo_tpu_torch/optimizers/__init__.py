from .antbo import AntBOOptimizer
from .base import AbstractOptimizer
from .bo_builder import BoBuilder, MCBOptimizer
from .hebo import HEBO

__all__ = ["AbstractOptimizer", "AntBOOptimizer", "BoBuilder", "HEBO", "MCBOptimizer"]
