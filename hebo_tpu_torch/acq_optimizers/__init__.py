from .evolution import EvolveSpaceMeta, GenDraws, evolve_raw
from .mcbo_opts import AcqOptimizerBase, LocalSearchAcqOptimizer, RandomSearchAcqOptimizer

__all__ = [
    "EvolveSpaceMeta", "GenDraws", "evolve_raw",
    "AcqOptimizerBase", "LocalSearchAcqOptimizer", "RandomSearchAcqOptimizer",
]
