"""HPO-B-style tabular/surrogate benchmark adapter (meta-BO evaluation): the port's own copy of ``hebo_tpu/tasks/hpob.py`` (host numpy,
the same numbers).

Parity: NAP's offline HPO-B evaluation (NAP/nap/environment/
function_gym_nap.py + results/HPO-B/*.json): BO episodes over *offline*
hyperparameter-response surfaces — suggestions snap to a finite candidate
table with precomputed objective values.

The real HPO-B JSON dumps are not shipped; ``load_json`` accepts the
HPO-B layout when present, and ``SyntheticHPOBTask.make_suite`` generates
GP-sample surrogate tables with the same interface for offline testing
and NAP meta-training.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = [
    "TabularBenchmark",
    "SyntheticHPOBTask",
    "load_meta_dataset",
    "run_hpob_eval",
]


class TabularBenchmark:
    """A finite (X, y) table acting as a black box: queries snap to the
    nearest candidate (the HPO-B discrete-search-space protocol)."""

    def __init__(self, X_table: np.ndarray, y_table: np.ndarray,
                 param_names: Optional[List[str]] = None):
        self.X_table = np.asarray(X_table, float)
        self.y_table = np.asarray(y_table, float).reshape(len(X_table))
        D = self.X_table.shape[1]
        self.param_names = param_names or [f"x{i}" for i in range(D)]

    @classmethod
    def load_json(cls, path: str, search_space_id: str, dataset_id: str):
        """HPO-B meta-dataset layout: {space: {dataset: {'X': …, 'y': …}}}.

        Real-schema notes (NAP/HPOB_data/convertHPOB.py:30-43): ``y`` is a
        list of single-element lists of accuracies in [0, 1] (maximize);
        we store the raw accuracy and leave min/max semantics to callers
        (``run_hpob_eval`` maximizes, BO loops minimize ``-y``)."""
        with open(path) as f:
            data = json.load(f)
        entry = data[search_space_id][dataset_id]
        y = np.asarray(entry["y"], float)
        if y.ndim == 2:  # real schema: (n, 1)
            y = y[:, 0]
        return cls(np.asarray(entry["X"], float), y)

    @property
    def space(self) -> DesignSpace:
        lb = self.X_table.min(axis=0)
        ub = self.X_table.max(axis=0)
        return DesignSpace([
            {"name": n, "type": "num", "lb": float(l), "ub": float(u + 1e-9)}
            for n, l, u in zip(self.param_names, lb, ub)
        ])

    def _snap(self, X: np.ndarray) -> np.ndarray:
        d = np.sum(
            (X[:, None, :] - self.X_table[None, :, :]) ** 2, axis=-1
        )
        return np.argmin(d, axis=1)

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        X = df[self.param_names].values.astype(float)
        idx = self._snap(X)
        return self.y_table[idx].reshape(-1, 1)

    @property
    def fmin(self) -> float:
        return float(self.y_table.min())

    def regret(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y) - self.fmin


class SyntheticHPOBTask(TabularBenchmark):
    """GP-sample surrogate table with the HPO-B interface."""

    def __init__(self, dim: int = 3, n_points: int = 512, seed: int = 0,
                 lengthscale: float = 0.3):
        rng = np.random.default_rng(seed)
        X = rng.random((n_points, dim))
        d2 = np.sum((X[:, None] - X[None, :]) ** 2, axis=-1)
        K = np.exp(-0.5 * d2 / lengthscale**2) + 1e-6 * np.eye(n_points)
        y = np.linalg.cholesky(K) @ rng.standard_normal(n_points)
        super().__init__(X, y)

    @classmethod
    def make_suite(cls, n_tasks: int = 4, dim: int = 3, seed: int = 0):
        return [cls(dim=dim, seed=seed + i) for i in range(n_tasks)]


def load_meta_dataset(path: str) -> Dict[str, Dict[str, TabularBenchmark]]:
    """Load a full HPO-B meta-dataset file (the real
    ``meta-{train,validation,test}-dataset.json`` layout used by
    NAP/HPOB_data/convertHPOB.py:30-43): {space_id: {dataset_id:
    {"X": [[...]], "y": [[...]]}}} → nested TabularBenchmark dict."""
    with open(path) as f:
        data = json.load(f)
    out: Dict[str, Dict[str, TabularBenchmark]] = {}
    for space_id, datasets in data.items():
        out[space_id] = {}
        for dataset_id, entry in datasets.items():
            y = np.asarray(entry["y"], float)
            if y.ndim == 2:
                y = y[:, 0]
            out[space_id][dataset_id] = TabularBenchmark(
                np.asarray(entry["X"], float), y
            )
    return out


def run_hpob_eval(
    benchmarks: Dict[str, Dict[str, TabularBenchmark]],
    make_optimizer=None,
    n_seeds: int = 5,
    n_trials: int = 50,
    n_init: int = 5,
    device="cuda",
) -> Dict[str, Dict[str, Dict[str, List[float]]]]:
    """Run BO episodes over HPO-B surfaces and emit the REFERENCE results
    schema (NAP/results/HPO-B/{NAP,GP,Random}.json): {space_id:
    {dataset_id: {"test<seed>": [best-so-far accuracy per trial]}}}.

    Accuracies are maximized (raw [0,1] values, exactly as the reference
    traces store them); BO internally minimizes ``-y``.  ``make_optimizer``
    defaults to HEBO; pass e.g. ``lambda space, seed: None`` semantics via
    a custom factory for baselines.  The default factory builds the port's
    ``HEBO`` on ``device``."""
    from ..optimizers.hebo import HEBO

    if make_optimizer is None:
        def make_optimizer(space, seed):
            return HEBO(space, rand_sample=n_init, scramble_seed=seed,
                        model_config={"num_epochs": 25, "n_restarts": 1},
                        pop=48, iters=32, device=device)

    results: Dict[str, Dict[str, Dict[str, List[float]]]] = {}
    for space_id, datasets in benchmarks.items():
        results[space_id] = {}
        for dataset_id, bench in datasets.items():
            traces: Dict[str, List[float]] = {}
            for seed in range(n_seeds):
                opt = make_optimizer(bench.space, seed)
                best = -np.inf
                trace = []
                for _ in range(n_trials):
                    rec = opt.suggest(1)
                    acc = float(bench(rec)[0, 0])
                    opt.observe(rec, np.asarray([[-acc]]))  # minimize -acc
                    best = max(best, acc)
                    trace.append(best)
                traces[f"test{seed}"] = trace
            results[space_id][dataset_id] = traces
    return results
