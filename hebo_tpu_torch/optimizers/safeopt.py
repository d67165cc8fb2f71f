"""SafeOpt: BO with high-probability safety constraints (port of
``hebo_tpu/optimizers/safeopt.py``; Sui et al. 2015, the candidate-set
form that febo vendors).  We minimize y, and a point is safe when y stays
below the threshold h:

  * safe set    S = {x : ucb(x) ≤ h} ∩ the Lipschitz cone of the observed
    safe points (a GP-only check is overconfident far from data);
  * minimizers  M = {x ∈ S : lcb(x) ≤ min_S ucb};
  * expanders   G = the points of S with the widest confidence interval
    (width quantile ``expander_quantile``);
  * each pick   argmax over M ∪ G of the width 2βσ.

The candidates are a fixed scrambled-Sobol set of ``n_candidates``,
predicted in one call on the model's device; the certification is host
numpy, as in the JAX package.  With no slope information yet it explores
a small ball around the safe incumbent; with no certified safe candidate
it re-suggests the best observed point.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models import get_model
from ..utils.device import resolve_device
from .base import AbstractOptimizer, timed

__all__ = ["SafeOpt"]


class SafeOpt(AbstractOptimizer):
    """Ask/tell safe BO; ``observe``'s y is both the objective and the
    safety signal."""

    def __init__(
        self,
        space,
        safety_threshold: float,
        beta: float = 2.0,
        lipschitz: Optional[float] = None,
        n_candidates: int = 1024,
        expander_quantile: float = 0.75,
        model_config: Optional[dict] = None,
        seed: int = 0,
        csv_save_path: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(space, csv_save_path)
        self.device = resolve_device(device)
        self.h = float(safety_threshold)
        self.beta = beta
        # Sui et al. (2015) safety certification is Lipschitz-based: a point
        # is safe only if some observed safe point certifies it within the
        # Lipschitz cone.  A GP-only ucb check is overconfident far from
        # data (the posterior reverts to the data mean).  None = estimate
        # from observed finite-difference slopes each iteration.
        self.lipschitz = lipschitz
        self.model_config = model_config or {"num_epochs": 30}
        self.model = None
        # a fixed candidate set, predicted in one batched call per suggest
        self._cands = space.sobol_sample_opt(n_candidates, seed=seed)
        self._expander_quantile = expander_quantile
        self._rng = np.random.default_rng(seed)

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if fix_input is not None:
            raise ValueError("SafeOpt does not support fix_input")
        X = self.space.transform(self.X) if self.num_obs else None
        if self.num_obs == 0:
            raise RuntimeError(
                "SafeOpt needs at least one observed SAFE point; observe an "
                "initial safe seed before suggesting"
            )
        y = self.y[:, :1]
        ok = np.isfinite(y[:, 0])
        Xv, yv = X[ok], y[ok]
        if not np.any(yv[:, 0] <= self.h):
            raise RuntimeError(
                f"no observed point satisfies the safety threshold {self.h}"
            )
        # fit on RAW y (the GP standardizes internally and predicts in the
        # raw frame): standardizing here with the tiny early-iteration std
        # would inflate the threshold and mark everything "safe"
        if self.model is None:
            self.model = get_model("gp", self.space, num_out=1, device=self.device,
                                   **self.model_config)
        with timed(self.fit_time, self.device):
            self.model.fit(Xv, yv)
        with timed(self.acq_time, self.device):
            mu, var = self.model.predict(self._cands)
        sd = np.sqrt(np.maximum(var[:, 0], 1e-12))
        lcb = mu[:, 0] - self.beta * sd
        ucb = mu[:, 0] + self.beta * sd

        # Lipschitz certification from observed safe points
        L = self.lipschitz
        if L is None:
            dx = np.linalg.norm(Xv[:, None] - Xv[None, :], axis=-1)
            dy = np.abs(yv[:, 0][:, None] - yv[:, 0][None, :])
            iu = np.triu_indices(len(Xv), k=1)
            ok_pair = dx[iu] > 1e-6
            if np.any(ok_pair):
                L = 1.5 * float(np.max(dy[iu][ok_pair] / dx[iu][ok_pair]))
            else:
                # no slope information yet: explore a small ball around the
                # safe incumbent instead of trusting the GP far afield
                best = Xv[np.argmin(yv[:, 0])]
                span = (self.space.opt_ub - self.space.opt_lb) * 0.05
                picks = [
                    self.space.round_opt(
                        np.clip(
                            best + self._rng.uniform(-1, 1, best.shape) * span,
                            self.space.opt_lb, self.space.opt_ub,
                        )
                    )
                    for _ in range(n_suggestions)
                ]
                return self.space.inverse_transform(np.stack(picks))
        safe_obs = yv[:, 0] <= self.h
        d_to_safe = np.linalg.norm(
            self._cands[:, None, :] - Xv[None, safe_obs, :], axis=-1
        )
        cert = np.min(yv[safe_obs, 0][None, :] + L * d_to_safe, axis=1) <= self.h
        safe = (ucb <= self.h) & cert  # GP confidence AND Lipschitz cone
        picks = []
        for _ in range(n_suggestions):
            if not np.any(safe):
                # fall back to the safest observed point's neighborhood:
                # re-suggest the best observed safe point (pure exploitation)
                best = Xv[np.argmin(yv[:, 0])]
                picks.append(best)
                continue
            ucb_s = np.where(safe, ucb, np.inf)
            lcb_s = np.where(safe, lcb, np.inf)
            # potential minimizers
            minimizers = safe & (lcb_s <= np.min(ucb_s))
            # expanders: safe points with large uncertainty (optimistic
            # boundary growth proxy — febo's safeopt uses per-constraint
            # expansion checks; width is the standard practical surrogate)
            w = 2.0 * self.beta * sd
            thresh = np.quantile(w[safe], self._expander_quantile)
            expanders = safe & (w >= thresh)
            cand_set = minimizers | expanders
            scores = np.where(cand_set, w, -np.inf)
            idx = int(np.argmax(scores))
            picks.append(self._cands[idx])
            safe = safe.copy()
            safe[idx] = False  # don't repeat within the batch
        return self.space.inverse_transform(np.stack(picks))

    @property
    def safe_incumbent(self):
        """Best observed point that satisfies the safety threshold."""
        y = self.y[:, 0]
        ok = np.isfinite(y) & (y <= self.h)
        if not np.any(ok):
            return None
        i = np.flatnonzero(ok)[np.argmin(y[ok])]
        return self.X.iloc[[i]], y[i]
