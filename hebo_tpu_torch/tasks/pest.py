"""Pest-control task (COMBO / MCBO categorical benchmark); the port's own
copy of ``hebo_tpu/tasks/pest.py`` (host numpy, the same numbers).

Parity: MCBO pest-control task (mcbo/tasks/ — the COMBO benchmark): a
chain of N stations each chooses one of 5 pesticide actions (incl. "do
nothing"); pest population spreads stochastically down the chain, each
pesticide has a price and an effectiveness that decays with repeated use
(resistance), and the objective is total cost = control price + damage
from surviving pests.  Deterministic given the seed (common random
numbers across evaluations — the standard benchmark protocol).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = ["PestControlTask"]

_N_CHOICE = 5  # 4 pesticides + none
_PRICES = np.asarray([0.0, 0.47, 0.77, 0.97, 1.17])
_BASE_KILL = np.asarray([0.0, 0.3, 0.47, 0.61, 0.73])
_DECAY = np.asarray([0.0, 0.1, 0.09, 0.08, 0.07])


class PestControlTask:
    def __init__(self, n_stations: int = 15, seed: int = 0):
        self.n_stations = n_stations
        self.seed = seed

    @property
    def space(self) -> DesignSpace:
        return DesignSpace([
            {"name": f"s{i}", "type": "cat",
             "categories": ["none", "p1", "p2", "p3", "p4"]}
            for i in range(self.n_stations)
        ])

    def _evaluate_one(self, actions: np.ndarray, rng: np.random.Generator) -> float:
        pop = 1.0  # normalized initial pest population
        cost = 0.0
        use_count = np.zeros(_N_CHOICE)
        for i in range(self.n_stations):
            a = int(actions[i])
            # spread: population grows stochastically between stations
            growth = rng.beta(2.0, 5.0) + 1.0
            pop = min(pop * growth, 4.0)
            if a > 0:
                # resistance: effectiveness decays with repeated use
                kill = _BASE_KILL[a] / (1.0 + _DECAY[a] * use_count[a])
                pop = pop * (1.0 - kill)
                cost += _PRICES[a]
                use_count[a] += 1
            cost += pop  # damage proportional to surviving population
        return cost

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        X = self.space.transform(df).astype(int)
        ys = []
        for row in X:
            rng = np.random.default_rng(self.seed)  # common random numbers
            ys.append(self._evaluate_one(row, rng))
        return np.asarray(ys, float).reshape(-1, 1)
