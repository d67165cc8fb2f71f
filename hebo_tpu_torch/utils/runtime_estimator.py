"""Runtime estimation / stuck detection for BO experiments (copy of
``hebo_tpu/utils/runtime_estimator.py``).

Parity: MCBO's runtime-prediction utility
(tests/analysis/test_runtime_estimator.py — fits per-iteration cost
growth to forecast total experiment time and flag stalls).  BO iteration
cost grows with N (kernel builds are O(N²)–O(N³)); fitting
t(n) = a + b·n^c on observed suggest times extrapolates the remaining
budget.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["RuntimeEstimator"]


class RuntimeEstimator:
    def __init__(self, stall_factor: float = 10.0):
        self.times: list = []
        self.stall_factor = stall_factor

    def record(self, seconds: float):
        self.times.append(float(seconds))

    def _fit(self):
        t = np.asarray(self.times)
        n = np.arange(1, len(t) + 1)
        if len(t) < 3:
            return np.array([t.mean() if len(t) else 0.0, 0.0])
        # robust linear fit of t(n) = a + b n (median-insensitive lstsq)
        A = np.stack([np.ones_like(n, float), n.astype(float)], axis=1)
        coef, *_ = np.linalg.lstsq(A, t, rcond=None)
        return coef

    def estimate_remaining(self, n_remaining: int) -> float:
        a, b = self._fit()
        n0 = len(self.times)
        ns = np.arange(n0 + 1, n0 + n_remaining + 1)
        return float(np.sum(np.maximum(a + b * ns, 0.0)))

    def is_stalled(self, current_elapsed: float) -> bool:
        """True if the in-flight iteration exceeds stall_factor × the
        predicted next-iteration time."""
        if len(self.times) < 3:
            return False
        a, b = self._fit()
        expect = max(a + b * (len(self.times) + 1), 1e-6)
        return current_elapsed > self.stall_factor * expect
