from .evolution import EvolutionOpt, EvolveSpaceMeta, GenDraws, evolve_raw
from .mcbo_opts import AcqOptimizerBase, LocalSearchAcqOptimizer, RandomSearchAcqOptimizer

__all__ = [
    "EvolutionOpt", "EvolveSpaceMeta", "GenDraws", "evolve_raw",
    "AcqOptimizerBase", "LocalSearchAcqOptimizer", "RandomSearchAcqOptimizer",
]
