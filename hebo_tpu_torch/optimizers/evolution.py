"""Evolution: the NSGA-II ask/tell optimizer with no surrogate (port of
``hebo_tpu/optimizers/evolution.py``).  The population persists across
calls: ``suggest`` mates the survivors (binary tournament on rank and
crowding, SBX + polynomial mutation, categorical crossover and reset, the
operators of ``acq_optimizers/evolution.py``) and ``observe`` keeps the
best ``pop`` of survivors and offspring.  The tournament's keys and the
survivors' order are kernel K5 on the card (``ops/pareto.nsga2_select``),
with no sort.  The draws of each generation come from a generator on the
device seeded 0, or are fed (``_mate``'s ``draws``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..acq_optimizers.evolution import (GenDraws, MetaTensors, _cat_ops, _poly_mutation,
                                        _round_discrete, _sbx_crossover, _space_meta,
                                        draw_generation, meta_tensors)
from ..ops.pareto import nsga2_select
from ..utils.device import resolve_device
from .base import AbstractOptimizer

__all__ = ["Evolution"]


def _mate(X: torch.Tensor, F: torch.Tensor, mt: MetaTensors, dr: GenDraws) -> torch.Tensor:
    """One round of mating of the population X (P, D) with objectives F
    (P, M) → P offspring, rounded (evolution.py:39-57)."""
    skey = nsga2_select(F)[2]
    sel = dr.sel.long()
    win = torch.where(skey[sel[0]] <= skey[sel[1]], sel[0], sel[1])
    p1, p2 = X[win], X[torch.roll(win, 1)]
    child_c = _sbx_crossover(p1, p2, mt.lb, mt.ub, dr.sbx_u, dr.sbx_do, dr.sbx_swap)
    child_c = _poly_mutation(child_c, mt.lb, mt.ub, dr.mut_u, dr.mut_do)
    child_k = _cat_ops(p1, p2, mt.lb, mt.ub, dr.cat_take, dr.cat_reset, dr.cat_u)
    return _round_discrete(torch.where(mt.is_cat[None, :], child_k, child_c), mt)


def _survive(X_all: torch.Tensor, F_all: torch.Tensor, pop_size: int):
    """The best ``pop_size`` rows by rank, then crowding (evolution.py:60-65)."""
    order = nsga2_select(F_all, pop_size)[3]
    return X_all[order], F_all[order]


class Evolution(AbstractOptimizer):
    support_parallel_opt = True
    support_multi_objective = True
    support_combinatorial = True

    def __init__(self, space, num_obj: int = 1, pop: int = 100,
                 csv_save_path: Optional[str] = None, device="cuda"):
        super().__init__(space, csv_save_path)
        self.device = resolve_device(device)
        self.num_obj = num_obj
        self.pop = pop
        self.meta = _space_meta(space)
        self._mt = meta_tensors(self.meta, self.device)
        self._X_pop: Optional[torch.Tensor] = None
        self._F_pop: Optional[torch.Tensor] = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self._pending: Optional[np.ndarray] = None

    def suggest(self, n_suggestions=None, fix_input=None):
        # one whole generation by default (population ask/tell)
        return super().suggest(n_suggestions, fix_input)

    def method_suggest(self, n_suggestions=None, fix_input=None):
        n = self.pop if n_suggestions is None else n_suggestions
        if self._X_pop is None:
            X = self.space.sobol_sample_opt(n, seed=0)
        else:
            P, D = self._X_pop.shape
            dr = draw_generation(P, D, self._gen, self.device)
            child = _mate(self._X_pop, self._F_pop, self._mt, dr).cpu().numpy()
            X = child[:n] if n <= len(child) else np.vstack(
                [child, self.space.sobol_sample_opt(n - len(child), seed=self.num_obs)])
        self._pending = X
        return self.space.inverse_transform(X)

    def observe_new_data(self, Xdf, y):
        Xn = self.space.transform(Xdf).astype(np.float32)
        F = np.asarray(y[:, : self.num_obj], np.float32)
        bad = ~np.all(np.isfinite(F), axis=1)
        if np.any(bad):
            fill = np.nanmax(F[~bad], axis=0) if np.any(~bad) else np.ones(self.num_obj)
            F[bad] = fill + 1.0
        f32 = dict(dtype=torch.float32, device=self.device)
        Xn, F = torch.as_tensor(Xn, **f32), torch.as_tensor(F, **f32)
        if self._X_pop is None:
            self._X_pop, self._F_pop = Xn, F
            return
        X_all = torch.cat([self._X_pop, Xn])
        F_all = torch.cat([self._F_pop, F])
        self._X_pop, self._F_pop = _survive(X_all, F_all, min(self.pop, len(X_all)))
