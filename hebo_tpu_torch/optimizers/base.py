"""Ask/tell optimizer base class (port of ``hebo_tpu/optimizers/base.py``).

``suggest(n)`` / ``observe(X, y)``; non-finite y rows stay in the history
and are masked out of model fitting.  Keeps per-call wall-clock timers.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import pandas as pd
import torch

__all__ = ["AbstractOptimizer", "timed"]


@contextlib.contextmanager
def timed(log: list, device):
    """Append the wall seconds of the block to ``log``, synchronizing a
    CUDA ``device`` at its end so that the block's kernels are in the
    time."""
    t0 = time.time()
    yield
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    log.append(time.time() - t0)


class AbstractOptimizer:
    support_parallel_opt = False
    support_combinatorial = False
    support_contextual = False
    support_constraint = False
    support_multi_objective = False

    def __init__(self, space, csv_save_path: Optional[str] = None):
        self.space = space
        self.csv_save_path = csv_save_path
        self.X = pd.DataFrame(columns=space.param_order)
        self.y = np.zeros((0, 1))
        self.suggest_time: list = []
        self.observe_time: list = []
        self.fit_time: list = []
        self.acq_time: list = []

    def suggest(self, n_suggestions: int = 1, fix_input: Optional[dict] = None):
        t0 = time.time()
        rec = self.method_suggest(n_suggestions, fix_input)
        self.suggest_time.append(time.time() - t0)
        return rec

    def observe(self, X: pd.DataFrame, y: np.ndarray):
        t0 = time.time()
        y = np.asarray(y, dtype=float).reshape(len(X), -1)
        if len(X) != len(y):
            raise ValueError("X and y have different lengths")
        self.X = pd.concat([self.X, X.copy()], axis=0, ignore_index=True)
        self.y = np.vstack([self.y, y]) if len(self.y) else y.copy()
        self.observe_new_data(X, y)
        self.observe_time.append(time.time() - t0)
        if self.csv_save_path is not None:
            out = self.X.copy()
            for i in range(self.y.shape[1]):
                out[f"y{i}"] = self.y[:, i]
            out.to_csv(self.csv_save_path, index=False)

    def method_suggest(self, n_suggestions: int, fix_input: Optional[dict]):
        raise NotImplementedError

    def observe_new_data(self, X: pd.DataFrame, y: np.ndarray):
        """Hook for subclasses."""

    @property
    def num_obs(self) -> int:
        return len(self.X)

    @property
    def best_id(self) -> int:
        y0 = self.y[:, 0].copy()
        y0[~np.isfinite(y0)] = np.inf
        return int(np.argmin(y0))

    @property
    def best_x(self) -> pd.DataFrame:
        return self.X.iloc[[self.best_id]]

    @property
    def best_y(self) -> float:
        return float(self.y[self.best_id, 0])
