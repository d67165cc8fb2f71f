"""MCBO-family acquisition optimizers over mixed/combinatorial spaces.

Port of ``hebo_tpu/acq_optimizers/mcbo_opts.py``: the ``AcqOptimizerBase``
contract (:56-116), ``RandomSearchAcqOptimizer`` (:119), the one-flip
neighbourhood (:132) and the COMBO-style greedy ``LocalSearchAcqOptimizer``
(:144).  The search itself is host numpy, as in the JAX package; each
candidate set is scored by one batched acquisition evaluation on the
model's device (``_score``), which returns numpy.

The simulated-annealing, interleaved, bandit and genetic optimizers are
ROADMAP slice 11's remainder.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..acquisitions.acq import AcqParams
from ..trust_region.casmo import ProxyTrManager

__all__ = [
    "AcqOptimizerBase",
    "RandomSearchAcqOptimizer",
    "LocalSearchAcqOptimizer",
]


class AcqOptimizerBase:
    def __init__(self, space, **kw):
        self.space = space

    # ---------------------------------------------------------- device eval
    @torch.no_grad()
    def _score(self, model, acq, acq_params, X) -> np.ndarray:
        """First acquisition column of the opt-frame rows X (P, D), as numpy."""
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=model.device)
        return acq.eval(model, model.state, acq_params, Xt)[:, 0].cpu().numpy()

    # ----------------------------------------------------------------- api
    def optimize(
        self,
        model,
        acq,
        acq_params: AcqParams,
        n_suggestions: int = 1,
        x_observed: Optional[np.ndarray] = None,
        tr_manager: Optional[ProxyTrManager] = None,
        seed: int = 0,
    ) -> np.ndarray:
        raise NotImplementedError

    # --------------------------------------------------------------- utils
    def _tr(self, tr_manager):
        return tr_manager if tr_manager is not None else ProxyTrManager(self.space)

    def _sample(self, tr, n, seed):
        if tr.active and tr.center is not None:
            return tr.sample_within_tr(n)
        return self.space.sobol_sample_opt(n, seed=seed)

    def _top_unique(self, X, scores, n, x_observed=None):
        order = np.argsort(scores)
        seen = set()
        if x_observed is not None:
            seen = {tuple(np.round(r, 6)) for r in x_observed}
        picks = []
        for i in order:
            k = tuple(np.round(X[i], 6))
            if k in seen:
                continue
            seen.add(k)
            picks.append(i)
            if len(picks) == n:
                break
        while len(picks) < n:  # top-up with best repeats if space exhausted
            picks.append(int(order[0]))
        return X[picks]


class RandomSearchAcqOptimizer(AcqOptimizerBase):
    def __init__(self, space, num_samples: int = 512, **kw):
        super().__init__(space, **kw)
        self.num_samples = num_samples

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0):
        tr = self._tr(tr_manager)
        X = self._sample(tr, self.num_samples, seed)
        s = self._score(model, acq, acq_params, X)
        return self._top_unique(X, s, n_suggestions, x_observed)


def _one_flip_neighbors(space, x: np.ndarray) -> np.ndarray:
    """All single-category-change neighbors of x (plus x itself)."""
    rows = [x]
    for c in space.cat_dims:
        for v in range(int(space.num_categories[c])):
            if v != int(x[c]):
                nb = x.copy()
                nb[c] = v
                rows.append(nb)
    return np.stack(rows)


class LocalSearchAcqOptimizer(AcqOptimizerBase):
    """COMBO-style greedy ascent over category-flip neighborhoods with
    numeric jitter; starts = incumbent sprays + random vertices."""

    def __init__(self, space, n_starts: int = 8, n_rounds: int = 8,
                 n_random: int = 256, **kw):
        super().__init__(space, **kw)
        self.n_starts = n_starts
        self.n_rounds = n_rounds
        self.n_random = n_random

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0):
        tr = self._tr(tr_manager)
        rng = np.random.default_rng(seed)
        cands = self._sample(tr, self.n_random, seed)
        s = self._score(model, acq, acq_params, cands)
        starts = cands[np.argsort(s)[: self.n_starts]].copy()
        if x_observed is not None and len(x_observed) and tr.center is not None:
            starts[0] = self.space.round_opt(tr.center.copy())

        nd = self.space.numeric_dims
        span = (self.space.opt_ub - self.space.opt_lb)[nd] if nd else None
        best_X, best_s = [], []
        for x in starts:
            x = x.copy()
            sx = self._score(model, acq, acq_params, x[None, :])[0]
            for _ in range(self.n_rounds):
                nbs = _one_flip_neighbors(self.space, x)
                if nd:
                    jit = np.repeat(x[None, :], 8, axis=0)
                    jit[:, nd] += 0.05 * span * rng.standard_normal((8, len(nd)))
                    nbs = np.vstack([nbs, self.space.round_opt(jit)])
                sc = self._score(model, acq, acq_params, nbs)
                j = int(np.argmin(sc))
                if sc[j] < sx - 1e-9:
                    x, sx = nbs[j].copy(), sc[j]
                else:
                    break
            best_X.append(x)
            best_s.append(sx)
        X = np.stack(best_X)
        return self._top_unique(X, np.asarray(best_s), n_suggestions, x_observed)
