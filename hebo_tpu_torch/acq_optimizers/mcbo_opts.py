"""MCBO-family acquisition optimizers over mixed/combinatorial spaces.

Port of ``hebo_tpu/acq_optimizers/mcbo_opts.py``: the ``AcqOptimizerBase``
contract (:56-116), ``RandomSearchAcqOptimizer`` (:119), the one-flip
neighbourhood (:132), the COMBO-style greedy ``LocalSearchAcqOptimizer``
(:144), BOCS's ``SimulatedAnnealingAcqOptimizer`` (:189), Casmopolitan's
``InterleavedSearchAcqOptimizer`` (:235), CoCaBO's ``MixedMabAcqOptimizer``
(:307) and the ``GeneticAlgoAcqOptimizer`` over ``EvolutionOpt`` (:368).
The search itself is host numpy, as in the JAX package, so one seed gives
the same ``np.random.default_rng`` draws in both; each candidate set is
scored by one batched acquisition evaluation on the model's device
(``_score``), which returns numpy.

The interleaved and bandit optimizers' numeric phase (:249-273) takes
``n_grad_steps`` plain gradient steps X − lr·(ub − lb)·g on the numeric
columns, clipped to the trust region's box; g is ``torch.autograd``'s
gradient of the summed acquisition through the model's posterior (on CUDA
the Matérn Gram's gradient in the query points is kernel K2's VJP).
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
    "SimulatedAnnealingAcqOptimizer",
    "InterleavedSearchAcqOptimizer",
    "MixedMabAcqOptimizer",
    "GeneticAlgoAcqOptimizer",
]


class AcqOptimizerBase:
    def __init__(self, space, **kw):
        self.space = space

    # ---------------------------------------------------------- device eval
    @torch.no_grad()
    def _score(self, model, acq, acq_params, X) -> np.ndarray:
        """First acquisition column of the opt-frame rows X (P, D), as numpy."""
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=model.device)
        return acq.eval_pure(model, model.state, acq_params, Xt)[:, 0].cpu().numpy()

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


class SimulatedAnnealingAcqOptimizer(AcqOptimizerBase):
    """SA over the mixed space: a population of walkers steps in parallel,
    all proposals scored in one device batch per round."""

    def __init__(self, space, n_walkers: int = 32, n_rounds: int = 64,
                 t0: float = 1.0, t1: float = 1e-2, **kw):
        super().__init__(space, **kw)
        self.n_walkers = n_walkers
        self.n_rounds = n_rounds
        self.t0, self.t1 = t0, t1

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0):
        tr = self._tr(tr_manager)
        rng = np.random.default_rng(seed)
        X = np.array(self._sample(tr, self.n_walkers, seed))
        s = np.array(self._score(model, acq, acq_params, X))
        nd, cd = self.space.numeric_dims, self.space.cat_dims
        lb, ub = tr.numeric_bounds()
        best_X, best_s = X.copy(), s.copy()
        for t in range(self.n_rounds):
            temp = self.t0 * (self.t1 / self.t0) ** (t / max(self.n_rounds - 1, 1))
            prop = X.copy()
            if nd:
                prop[:, nd] += 0.1 * (ub - lb)[nd] * rng.standard_normal((len(X), len(nd)))
            if cd:
                for i in range(len(prop)):
                    c = cd[rng.integers(len(cd))]
                    prop[i, c] = rng.integers(int(self.space.num_categories[c]))
            prop = np.clip(prop, lb, ub)
            prop = self.space.round_opt(prop)
            sp = self._score(model, acq, acq_params, prop)
            accept = (sp < s) | (
                rng.random(len(X)) < np.exp(np.clip(-(sp - s) / max(temp, 1e-9), -50.0, 0.0))
            )
            X[accept] = prop[accept]
            s[accept] = sp[accept]
            imp = s < best_s
            best_X[imp] = X[imp]
            best_s[imp] = s[imp]
        return self._top_unique(best_X, best_s, n_suggestions, x_observed)


class InterleavedSearchAcqOptimizer(AcqOptimizerBase):
    """Casmopolitan: alternate gradient steps on the numerics with best
    one-flip hill climbing on the categoricals, inside the trust region."""

    def __init__(self, space, n_starts: int = 8, n_rounds: int = 4,
                 n_grad_steps: int = 16, grad_lr: float = 0.05, **kw):
        super().__init__(space, **kw)
        self.n_starts = n_starts
        self.n_rounds = n_rounds
        self.n_grad_steps = n_grad_steps
        self.grad_lr = grad_lr

    def descend(self, model, acq, acq_params, X, lb, ub) -> np.ndarray:
        """``n_grad_steps`` steps X − lr·(ub − lb)·g of the numeric columns,
        each clipped to [lb, ub], with g the gradient of the summed first
        acquisition column (mcbo_opts.py:249-273).  Returns numpy."""
        dev = model.device
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
        lb_t, ub_t = f32(lb), f32(ub)
        num = torch.zeros(self.space.num_cols, dtype=torch.bool, device=dev)
        num[list(self.space.numeric_dims)] = True
        step = self.grad_lr * (ub_t - lb_t)
        state = model.state
        Xc = f32(X)
        for _ in range(self.n_grad_steps):
            Xg = Xc.detach().requires_grad_(True)
            with torch.enable_grad():
                total = acq.eval_pure(model, state, acq_params, Xg)[:, 0].sum()
                g, = torch.autograd.grad(total, Xg)
            upd = torch.where(num[None, :], g, torch.zeros_like(g))
            Xc = torch.minimum(torch.maximum(Xc - step * upd, lb_t), ub_t)
        return Xc.detach().cpu().numpy()

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0):
        tr = self._tr(tr_manager)
        X = self._sample(tr, self.n_starts, seed)
        if tr.center is not None:
            X[0] = self.space.round_opt(tr.center.copy())
        lb, ub = tr.numeric_bounds()
        nd, cd = self.space.numeric_dims, self.space.cat_dims
        for _ in range(self.n_rounds):
            if nd:
                X = self.descend(model, acq, acq_params, X, lb, ub)
                X = self.space.round_opt(np.clip(X, lb, ub))
            if cd:
                for i in range(len(X)):
                    nbs = _one_flip_neighbors(self.space, X[i])
                    if tr.center is not None:
                        ham = np.sum(nbs[:, cd] != tr.center[None, cd], axis=1)
                        nbs = nbs[ham <= tr.cat_budget()]
                    sc = self._score(model, acq, acq_params, nbs)
                    X[i] = nbs[int(np.argmin(sc))]
        s = self._score(model, acq, acq_params, X)
        return self._top_unique(X, s, n_suggestions, x_observed)


class MixedMabAcqOptimizer(AcqOptimizerBase):
    """CoCaBO: an EXP3 bandit per categorical dim draws the category
    values; the numerics then take the interleaved optimizer's gradient
    steps.  The bandit's weights persist across calls and change only in
    ``update_rewards``."""

    def __init__(self, space, gamma: float = 0.1, n_grad_steps: int = 32,
                 grad_lr: float = 0.05, n_cand: int = 16, **kw):
        super().__init__(space, **kw)
        self.gamma = gamma
        self.n_cand = n_cand
        self.weights = {c: np.ones(int(space.num_categories[c])) for c in space.cat_dims}
        self._inner = InterleavedSearchAcqOptimizer(
            space, n_starts=n_cand, n_rounds=1, n_grad_steps=n_grad_steps, grad_lr=grad_lr,
        )

    def _draw_cats(self, rng):
        out = {}
        for c, w in self.weights.items():
            K = len(w)
            p = (1 - self.gamma) * w / w.sum() + self.gamma / K
            out[c] = rng.choice(K, p=p)
        return out

    def update_rewards(self, cats: dict, reward: float):
        """EXP3 importance-weighted update for the drawn arms."""
        for c, v in cats.items():
            w = self.weights[c]
            K = len(w)
            p = (1 - self.gamma) * w / w.sum() + self.gamma / K
            w[v] *= np.exp(self.gamma * reward / (K * p[v]))
            self.weights[c] = np.clip(w / w.max(), 1e-8, None)

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0):
        tr = self._tr(tr_manager)
        rng = np.random.default_rng(seed)
        X = self._sample(tr, self.n_cand, seed)
        self.last_cats = []
        for i in range(len(X)):
            cats = self._draw_cats(rng)
            for c, v in cats.items():
                X[i, c] = v
            self.last_cats.append(cats)
        if self.space.numeric_dims:
            lb, ub = tr.numeric_bounds()
            X = self.space.round_opt(self._inner.descend(model, acq, acq_params, X, lb, ub))
        s = self._score(model, acq, acq_params, X)
        return self._top_unique(X, s, n_suggestions, x_observed)


class GeneticAlgoAcqOptimizer(AcqOptimizerBase):
    """Category-aware GA: ``EvolutionOpt`` (NSGA-II on the model's device,
    kernel K5 on CUDA) from a population sampled in the trust region."""

    def __init__(self, space, pop: int = 64, iters: int = 32, **kw):
        super().__init__(space, **kw)
        self.pop = pop
        self.iters = iters
        self._evo = None

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0, draws=None):
        """``draws(gen) → GenDraws`` replaces the generations' random
        numbers, as in ``EvolutionOpt.optimize``."""
        from .evolution import EvolutionOpt

        tr = self._tr(tr_manager)
        if self._evo is None:
            self._evo = EvolutionOpt(self.space, acq, pop=self.pop, iters=self.iters)
        self._evo.acq = acq
        init = self._sample(tr, self.pop, seed)
        pop_X, pop_F = self._evo.optimize(
            model=model, acq_params=acq_params, initial_suggest=init,
            return_pop=True, seed=seed, draws=draws,
        )
        return self._top_unique(pop_X, pop_F[:, 0], n_suggestions, x_observed)
