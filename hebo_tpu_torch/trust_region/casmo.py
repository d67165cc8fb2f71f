"""Casmopolitan trust-region manager (copy of ``hebo_tpu/trust_region/casmo.py``).

Parity: MCBO ``CasmopolitanTrManager`` / ``TrManagerBase``
(MCBO/mcbo/trust_region/casmo_tr_manager.py:28-257):
  * per-variable-type radii: numeric radius in [2⁻⁵, 1] (fraction of the
    box), categorical radius = a Hamming-distance budget,
  * success/fail counters → ×1.5 expand on ``succ_tol`` successes, ÷1.5
    shrink on ``fail_tol`` failures,
  * restart with a fresh center when the numeric radius collapses below
    ``min_radius``, away from the previous centers,
  * ``sample_within_tr``: numeric dims uniform in the clipped box, cat
    dims = center with at most ``ceil(r_cat · C)`` dims resampled.

The state is a handful of host scalars and all sampling is numpy, so the
port keeps its own copy: one seed gives the JAX package's draws exactly.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

__all__ = ["CasmopolitanTrManager", "ProxyTrManager"]


class ProxyTrManager:
    """Full-space no-op TR (MCBO wraps no-TR acq-opts in one, :107-117)."""

    def __init__(self, space):
        self.space = space
        self.center: Optional[np.ndarray] = None

    @property
    def active(self) -> bool:
        return False

    def numeric_bounds(self):
        return self.space.opt_lb.copy(), self.space.opt_ub.copy()

    def cat_budget(self) -> int:
        return len(self.space.cat_dims)

    def adjust(self, y_new: float, best_y: float):
        pass

    def register_center(self, x_opt: np.ndarray):
        self.center = np.asarray(x_opt, float)

    @property
    def needs_restart(self) -> bool:
        return False

    def restart(self, seed: int = 0):
        pass


class CasmopolitanTrManager(ProxyTrManager):
    def __init__(
        self,
        space,
        succ_tol: int = 3,
        fail_tol: int = 40,
        radius_init: float = 0.4,
        radius_min: float = 2.0**-5,
        radius_max: float = 1.0,
        cat_radius_init: Optional[float] = None,
        seed: int = 0,
    ):
        super().__init__(space)
        self.succ_tol = succ_tol
        self.fail_tol = fail_tol
        self.radius_init = radius_init
        self.radius_min = radius_min
        self.radius_max = radius_max
        self.cat_radius_init = (
            cat_radius_init if cat_radius_init is not None else radius_init
        )
        self._rng = np.random.default_rng(seed)
        self.restart_count = 0
        self.prev_centers: list = []
        self._reset_state()

    def _reset_state(self):
        self.radius = self.radius_init
        self.cat_radius = self.cat_radius_init
        self.succ_count = 0
        self.fail_count = 0
        self.center = None
        self._best_in_tr = math.inf

    @property
    def active(self) -> bool:
        return True

    # ------------------------------------------------------------- geometry
    def numeric_bounds(self):
        lb = self.space.opt_lb.copy()
        ub = self.space.opt_ub.copy()
        if self.center is None:
            return lb, ub
        span = ub - lb
        nd = self.space.numeric_dims
        c = self.center
        lb2, ub2 = lb.copy(), ub.copy()
        lb2[nd] = np.maximum(lb[nd], c[nd] - self.radius * span[nd])
        ub2[nd] = np.minimum(ub[nd], c[nd] + self.radius * span[nd])
        return lb2, ub2

    def cat_budget(self) -> int:
        C = len(self.space.cat_dims)
        if self.center is None or C == 0:
            return C
        return max(1, int(math.ceil(self.cat_radius * C)))

    def sample_within_tr(self, n: int) -> np.ndarray:
        """Uniform sample inside the TR (numeric box + Hamming ball)."""
        lb, ub = self.numeric_bounds()
        X = lb + self._rng.random((n, self.space.num_cols)) * (ub - lb)
        cd = self.space.cat_dims
        if cd and self.center is not None:
            budget = self.cat_budget()
            for i in range(n):
                X[i, cd] = self.center[cd]
                k = self._rng.integers(1, budget + 1)
                flip = self._rng.choice(len(cd), size=min(k, len(cd)), replace=False)
                for j in flip:
                    c = cd[j]
                    X[i, c] = self._rng.integers(0, int(self.space.num_categories[c]) + 0)
        return self.space.round_opt(X)

    # ------------------------------------------------------------- dynamics
    def adjust(self, y_new: float, best_y: float):
        """Success = improved on the incumbent (with the standard 1e-3
        relative slack); counters drive expand/shrink (:115-136)."""
        if y_new < best_y - 1e-3 * abs(best_y):
            self.succ_count += 1
            self.fail_count = 0
        else:
            self.fail_count += 1
            self.succ_count = 0
        if self.succ_count >= self.succ_tol:
            self.radius = min(self.radius * 1.5, self.radius_max)
            self.cat_radius = min(self.cat_radius * 1.5, 1.0)
            self.succ_count = 0
        elif self.fail_count >= self.fail_tol:
            self.radius /= 1.5
            self.cat_radius /= 1.5
            self.fail_count = 0

    @property
    def needs_restart(self) -> bool:
        return self.radius < self.radius_min

    def restart(self, seed: int = 0):
        """Guided restart: remember the old center, re-center elsewhere
        (distance-max among random candidates — :137-232)."""
        if self.center is not None:
            self.prev_centers.append(self.center.copy())
        self.restart_count += 1
        self._reset_state()
        cands = self.space.sobol_sample_opt(64, seed=seed + self.restart_count)
        if self.prev_centers:
            P = np.stack(self.prev_centers)
            d = np.min(
                np.linalg.norm(cands[:, None, :] - P[None, :, :], axis=-1), axis=1
            )
            self.center = cands[int(np.argmax(d))]
        else:
            self.center = cands[0]
