"""LassoBench-style high-dimensional weighted-lasso HPO tasks: the port's own copy of ``hebo_tpu/tasks/lasso.py`` (host numpy,
the same numbers).

Parity: RDUCB's LassoBench benchmark rows (RDUCB/hdbo/datasets.py:1-1073,
config/LassoBench/*.yml) — tune one penalty weight per feature of a lasso
regression (adaptive lasso), validation MSE as the black box.  This is the
reference's flagship high-dimensional (D 60-300) decomposition benchmark:
the objective is near-additive over feature groups, which is what RDUCB's
random-decomposition GP + message-passing maximizer exploits.

The weighted lasso  min ‖y − Xβ‖² + α Σ_j w_j |β_j|  is solved as a
standard lasso on rescaled features X̃_j = X_j / w_j with β_j = β̃_j / w_j
(sklearn host-side; black boxes stay on CPU by design, SURVEY.md §7).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = ["LassoBenchTask"]

_PRESETS = {
    # name: (n_features, n_informative, n_samples)
    "synt_simple": (60, 3, 120),
    "synt_medium": (100, 5, 200),
    "synt_high": (300, 15, 450),
}


class LassoBenchTask:
    """θ ∈ [-1, 1]^D → per-feature penalty weight exp(θ·scale); minimize
    validation MSE of the induced adaptive lasso."""

    def __init__(self, preset: str = "synt_simple", seed: int = 42,
                 alpha: float = 0.1, weight_log_range: float = 2.0,
                 noise: float = 0.1):
        if preset not in _PRESETS:
            raise ValueError(f"unknown preset {preset!r}; known: {sorted(_PRESETS)}")
        self.preset = preset
        D, k, n = _PRESETS[preset]
        self.dim = D
        self.alpha = alpha
        self.scale = weight_log_range
        rng = np.random.default_rng(seed)
        X = rng.standard_normal((n, D))
        beta = np.zeros(D)
        support = rng.choice(D, size=k, replace=False)
        beta[support] = rng.standard_normal(k) * 2.0
        y = X @ beta + noise * rng.standard_normal(n)
        n_tr = int(0.7 * n)
        self._Xtr, self._ytr = X[:n_tr], y[:n_tr]
        self._Xva, self._yva = X[n_tr:], y[n_tr:]
        self.space = DesignSpace(
            [{"name": f"w{j}", "type": "num", "lb": -1.0, "ub": 1.0} for j in range(D)]
        )

    @property
    def name(self) -> str:
        return f"lasso-{self.preset}"

    def _eval_one(self, theta: np.ndarray) -> float:
        from sklearn.linear_model import Lasso

        w = np.exp(self.scale * np.clip(theta, -1.0, 1.0))
        Xs = self._Xtr / w[None, :]
        try:
            m = Lasso(alpha=self.alpha, max_iter=2000)
            m.fit(Xs, self._ytr)
            beta = m.coef_ / w
            pred = self._Xva @ beta + m.intercept_
            return float(np.mean((pred - self._yva) ** 2))
        except Exception:
            return float("inf")

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        cols = [f"w{j}" for j in range(self.dim)]
        theta = df[cols].values.astype(np.float64)
        return np.asarray(
            [self._eval_one(t) for t in theta], np.float64
        ).reshape(-1, 1)
