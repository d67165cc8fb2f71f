"""Non-BO baselines and LineBO (port of ``hebo_tpu/optimizers/baselines.py``):
random search, hill climbing, simulated annealing and an EXP3 bandit (MCBO's
non-BO optimizers), and BO along random lines through the incumbent
(febo's LineBO).  They are host numpy with the JAX package's generators,
so the two packages suggest the same points; ``LineBO`` fits the port's GP
and scores each line's candidates in one batched LCB evaluation on the
model's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..acquisitions.acq import LCB, AcqParams
from ..models import get_model
from ..utils.device import resolve_device
from .base import AbstractOptimizer

__all__ = ["RandomSearch", "HillClimbing", "SimulatedAnnealing", "LineBO", "MultiArmedBandit"]


class RandomSearch(AbstractOptimizer):
    def __init__(self, space, sobol: bool = True, csv_save_path=None):
        super().__init__(space, csv_save_path)
        self.sobol = sobol
        self._count = 0

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.sobol:
            X = self.space.sobol_sample_opt(n_suggestions, seed=self._count)
            self._count += 1
            df = self.space.inverse_transform(X)
        else:
            df = self.space.sample(n_suggestions, seed=self._count)
            self._count += 1
        if fix_input:
            for k, v in fix_input.items():
                df[k] = v
        return df


class HillClimbing(AbstractOptimizer):
    """Stochastic hill climbing: perturb the incumbent; accept improvements
    implicitly through the incumbent tracking."""

    def __init__(self, space, step_frac: float = 0.1, csv_save_path=None):
        super().__init__(space, csv_save_path)
        self.step_frac = step_frac
        self._rng = np.random.default_rng(0)

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.num_obs == 0:
            return self.space.inverse_transform(
                self.space.sobol_sample_opt(n_suggestions, seed=0)
            )
        x0 = self.space.transform(self.best_x)[0]
        span = self.space.opt_ub - self.space.opt_lb
        X = np.repeat(x0[None, :], n_suggestions, axis=0)
        nd = self.space.numeric_dims
        if nd:
            X[:, nd] += self.step_frac * span[nd] * self._rng.standard_normal(
                (n_suggestions, len(nd))
            )
        for c in self.space.cat_dims:
            flip = self._rng.random(n_suggestions) < 1.0 / max(
                len(self.space.cat_dims), 1
            )
            X[flip, c] = self._rng.integers(
                0, int(self.space.num_categories[c]), size=int(flip.sum())
            )
        X = np.clip(X, self.space.opt_lb, self.space.opt_ub)
        return self.space.inverse_transform(self.space.round_opt(X))


class SimulatedAnnealing(AbstractOptimizer):
    """Ask/tell SA with geometric cooling (non_bo SA parity)."""

    def __init__(self, space, t0: float = 1.0, cooling: float = 0.95,
                 step_frac: float = 0.15, csv_save_path=None):
        super().__init__(space, csv_save_path)
        self.temp = t0
        self.cooling = cooling
        self.step_frac = step_frac
        self._rng = np.random.default_rng(0)
        self._current_x: Optional[np.ndarray] = None
        self._current_y = np.inf
        self._pending = None

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self._current_x is None:
            X = self.space.sobol_sample_opt(n_suggestions, seed=0)
        else:
            span = self.space.opt_ub - self.space.opt_lb
            X = np.repeat(self._current_x[None, :], n_suggestions, axis=0)
            nd = self.space.numeric_dims
            if nd:
                X[:, nd] += self.step_frac * span[nd] * self._rng.standard_normal(
                    (n_suggestions, len(nd))
                )
            for c in self.space.cat_dims:
                flip = self._rng.random(n_suggestions) < 0.3
                X[flip, c] = self._rng.integers(
                    0, int(self.space.num_categories[c]), size=int(flip.sum())
                )
            X = np.clip(X, self.space.opt_lb, self.space.opt_ub)
        X = self.space.round_opt(X)
        self._pending = X
        return self.space.inverse_transform(X)

    def observe_new_data(self, Xdf, y):
        if self._pending is None:
            return
        y0 = np.asarray(y[:, 0], float)
        j = int(np.nanargmin(np.where(np.isfinite(y0), y0, np.inf)))
        cand_y = y0[j]
        if not np.isfinite(cand_y):
            return
        accept = cand_y < self._current_y or self._rng.random() < np.exp(
            np.clip(-(cand_y - self._current_y) / max(self.temp, 1e-9), -50, 0)
        )
        if accept:
            self._current_x = self._pending[j]
            self._current_y = cand_y
        self.temp *= self.cooling
        self._pending = None


class LineBO(AbstractOptimizer):
    """BO along random 1-D lines through the incumbent (LineBO/febo)."""

    def __init__(self, space, n_init: int = 5, line_points: int = 32,
                 model_config=None, csv_save_path=None, device="cuda"):
        super().__init__(space, csv_save_path)
        if space.cat_dims:
            raise ValueError("LineBO supports continuous spaces")
        self.device = resolve_device(device)
        self.n_init = n_init
        self.line_points = line_points
        self.model_config = model_config or {"num_epochs": 20}
        self._rng = np.random.default_rng(0)
        self._count = 0
        self.model = None

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.num_obs < self.n_init:
            X = self.space.sobol_sample_opt(n_suggestions, seed=self._count)
            self._count += 1
            return self.space.inverse_transform(X)

        X = self.space.transform(self.X)
        y = self.y[:, :1]
        ok = np.isfinite(y[:, 0])
        Xv, yv = X[ok], y[ok]
        ys = (yv - yv.mean()) / max(yv.std(), 1e-12)
        if self.model is None:
            self.model = get_model("gp", self.space, num_out=1, device=self.device,
                                   **self.model_config)
        self.model.fit(Xv, ys)

        x0 = Xv[int(np.argmin(ys[:, 0]))]
        span = self.space.opt_ub - self.space.opt_lb
        acq, recs = LCB(), []
        for _ in range(n_suggestions):
            # a random direction; the grid of its segment through x0
            d = self._rng.standard_normal(self.space.num_cols)
            d /= np.linalg.norm(d)
            ts = np.linspace(-1.0, 1.0, self.line_points)
            cand = x0[None, :] + ts[:, None] * (d * span)[None, :]
            cand = np.clip(cand, self.space.opt_lb, self.space.opt_ub)
            with torch.no_grad():
                scores = acq.eval_pure(self.model, self.model.state, AcqParams(kappa=2.0),
                                  torch.as_tensor(cand, dtype=torch.float32, device=self.device))
            recs.append(cand[int(np.argmin(scores[:, 0].cpu().numpy()))])
        return self.space.inverse_transform(np.stack(recs))


class MultiArmedBandit(AbstractOptimizer):
    """EXP3 bandit optimizer over categorical/discrete spaces.

    Parity: MCBO non-BO ``multi_armed_bandit`` (optimizers/non_bo/): one
    EXP3 learner per categorical dimension (independent-arms
    factorization, the CoCaBO building block — see
    acq_optimizers/mcbo_opts.py for the inner-loop variant); numeric dims,
    if any, are sampled uniformly.  Rewards are importance-weighted
    improvements normalized by a running y-range.
    """

    def __init__(self, space, gamma: float = 0.1, csv_save_path=None):
        super().__init__(space, csv_save_path)
        self.gamma = float(gamma)
        self._rng = np.random.default_rng(0)
        self._w = [
            np.ones(int(space.num_categories[c])) for c in space.cat_dims
        ]
        self._pending: Optional[np.ndarray] = None
        self._probs: Optional[list] = None
        self._y_lo = np.inf
        self._y_hi = -np.inf

    def _arm_probs(self, w: np.ndarray) -> np.ndarray:
        p = w / w.sum()
        return (1.0 - self.gamma) * p + self.gamma / len(w)

    def method_suggest(self, n_suggestions=1, fix_input=None):
        lb, ub = self.space.opt_lb, self.space.opt_ub
        X = self._rng.uniform(lb, ub, size=(n_suggestions, len(lb)))
        self._probs = [self._arm_probs(w) for w in self._w]
        for k, c in enumerate(self.space.cat_dims):
            X[:, c] = self._rng.choice(
                len(self._probs[k]), size=n_suggestions, p=self._probs[k]
            )
        X = self.space.round_opt(np.clip(X, lb, ub))
        self._pending = X
        df = self.space.inverse_transform(X)
        if fix_input:
            for k, v in fix_input.items():
                df[k] = v
        return df

    def observe_new_data(self, Xdf, y):
        if self._pending is None or self._probs is None:
            return
        y0 = np.asarray(y[:, 0], float)
        fin = np.isfinite(y0)
        if fin.any():
            self._y_lo = min(self._y_lo, float(y0[fin].min()))
            self._y_hi = max(self._y_hi, float(y0[fin].max()))
        span = max(self._y_hi - self._y_lo, 1e-9)
        n = min(len(y0), len(self._pending))
        for i in range(n):
            if not fin[i]:
                continue
            reward = (self._y_hi - y0[i]) / span  # minimization → high reward
            for k, c in enumerate(self.space.cat_dims):
                a = int(self._pending[i, c])
                xhat = reward / max(self._probs[k][a], 1e-9)
                self._w[k][a] *= np.exp(
                    np.clip(self.gamma * xhat / len(self._w[k]), 0.0, 50.0)
                )
            # renormalize to dodge overflow on long runs
        for k in range(len(self._w)):
            m = self._w[k].max()
            if m > 1e6:
                self._w[k] /= m
        self._pending = None
        self._probs = None
