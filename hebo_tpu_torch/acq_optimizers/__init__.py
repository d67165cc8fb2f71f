from .evolution import EvolutionOpt, EvolveSpaceMeta, GenDraws, evolve_raw
from .mcbo_opts import (AcqOptimizerBase, GeneticAlgoAcqOptimizer, InterleavedSearchAcqOptimizer,
                        LocalSearchAcqOptimizer, MixedMabAcqOptimizer, RandomSearchAcqOptimizer,
                        SimulatedAnnealingAcqOptimizer)

__all__ = [
    "EvolutionOpt", "EvolveSpaceMeta", "GenDraws", "evolve_raw",
    "AcqOptimizerBase", "LocalSearchAcqOptimizer", "RandomSearchAcqOptimizer",
    "SimulatedAnnealingAcqOptimizer", "InterleavedSearchAcqOptimizer", "MixedMabAcqOptimizer",
    "GeneticAlgoAcqOptimizer",
]
