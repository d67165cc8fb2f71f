from .antbo import AntBOOptimizer
from .base import AbstractOptimizer
from .bo_builder import BO_ALGOS, BoBuilder, MCBOptimizer
from .hebo import HEBO

__all__ = ["AbstractOptimizer", "AntBOOptimizer", "BO_ALGOS", "BoBuilder", "HEBO", "MCBOptimizer"]
