"""GeneralBO: multi-objective and constrained BO with EHVI batch selection
(port of ``hebo_tpu/optimizers/general.py``).

One GP per output (``MultiTaskModel``, ``model_name="multi_task"``),
``GeneralAcq`` (per-output LCB objectives, constraint outputs feasible
below 0) minimized by NSGA-II, and, with more than one objective, a batch
picked greedily by Monte-Carlo expected hypervolume improvement (:102-128).

Each greedy round draws one set of uniforms (n_samples, M) from a
generator on the model's device seeded by the observation count, and every
candidate of the round is scored on that draw (common random numbers, as
the JAX package's one key per round does): the hypervolume of the front so
far plus each candidate, all candidates as one (P, n_samples, R + 1, M)
tensor.  Each round's gains come back to the host once, for the argmax.

As in the JAX package, ``GeneralAcq`` reads κ from ``AcqParams`` and
``GeneralBO`` passes the default ``AcqParams()``, so ``kappa`` is 2.0
whatever the constructor was given (general.py:89; an open fault in both
packages).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..acq_optimizers.evolution import EvolutionOpt
from ..acquisitions.acq import AcqParams, GeneralAcq
from ..models import get_model
from ..ops.pareto import hypervolume_mc, pareto_mask
from ..utils.device import resolve_device
from .base import AbstractOptimizer, timed

__all__ = ["GeneralBO"]


class GeneralBO(AbstractOptimizer):
    support_multi_objective = True
    support_constraint = True
    support_parallel_opt = True

    def __init__(
        self,
        space,
        num_obj: int = 1,
        num_constr: int = 0,
        model_name: str = "multi_task",
        rand_sample: Optional[int] = None,
        kappa: float = 2.0,
        c_kappa: float = 0.0,
        model_config: Optional[dict] = None,
        pop: int = 100,
        iters: int = 100,
        csv_save_path: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(space, csv_save_path)
        self.device = resolve_device(device)
        self.num_obj = num_obj
        self.num_constr = num_constr
        self.num_out = num_obj + num_constr
        self.model_name = model_name
        self.rand_sample = rand_sample if rand_sample is not None else 1 + space.num_cols
        self.model_config = model_config or {}
        self.pop = pop
        self.iters = iters
        self._acq = GeneralAcq(num_obj, num_constr, kappa=kappa, c_kappa=c_kappa)
        self.model = None
        self._evo = None
        self._sobol_count = 0
        self.ehvi_time: list = []

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.num_obs < self.rand_sample:
            X = self.space.sobol_sample_opt(n_suggestions, seed=self._sobol_count)
            self._sobol_count += 1
            return self.space.inverse_transform(X)

        X = self.space.transform(self.X)
        Y = self.y[:, : self.num_out].copy()
        ok = np.all(np.isfinite(Y), axis=1)
        Xv, Yv = X[ok], Y[ok]
        Ys = (Yv - Yv.mean(axis=0)) / np.maximum(Yv.std(axis=0), 1e-12)

        if self.model is None:
            self.model = get_model(self.model_name, self.space, num_out=self.num_out,
                                   device=self.device, **self.model_config)
        with timed(self.fit_time, self.device):
            self.model.fit(Xv, Ys)

        if self._evo is None:
            self._evo = EvolutionOpt(self.space, self._acq, pop=self.pop, iters=self.iters)
        with timed(self.acq_time, self.device):
            pop_X, pop_F = self._evo.optimize(model=self.model, acq_params=AcqParams(),
                                              fix_input=fix_input, return_pop=True,
                                              seed=self.num_obs)

        if self.num_obj == 1:
            order = np.argsort(pop_F[:, 0])
            rec = pop_X[order[:n_suggestions]]
        else:
            with timed(self.ehvi_time, self.device):
                rec = self._ehvi_select(pop_X, n_suggestions, Ys[:, : self.num_obj])
        return self.space.inverse_transform(rec)

    def _ehvi_select(self, cand_X, n, Y_obs, uniforms=None, n_samples: int = 2048):
        """Greedy Monte-Carlo hypervolume-improvement batch of ``n`` rows of
        ``cand_X`` (general.py:102-128).  ``uniforms`` (n, n_samples, M)
        replaces the generator's draws, one set per round."""
        dev = self.device
        mu, _ = self.model.predict(cand_X)
        Fc = mu[:, : self.num_obj]
        ref = torch.as_tensor(np.maximum(Y_obs.max(axis=0), Fc.max(axis=0)) + 0.1,
                              dtype=torch.float32, device=dev)
        Y32 = torch.as_tensor(Y_obs, dtype=torch.float32, device=dev)
        base = Y32[pareto_mask(Y32)]
        Fc_t = torch.as_tensor(Fc, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(self.num_obs)
        selected = []
        for r in range(n):
            u = (torch.rand((n_samples, self.num_obj), generator=gen, device=dev)
                 if uniforms is None else torch.as_tensor(uniforms[r], device=dev))
            sets = torch.cat([base.expand(len(Fc_t), -1, -1), Fc_t[:, None, :]], 1)
            hv = torch.cat([hypervolume_mc(sets, ref, u), hypervolume_mc(base, ref, u)[None]])
            hv = hv.cpu().numpy()
            gains = hv[:-1].astype(np.float64) - float(hv[-1])
            gains[selected] = -np.inf
            pick = int(np.argmax(gains))
            selected.append(pick)
            base = torch.cat([base, Fc_t[pick : pick + 1]])
        return cand_X[selected]

    def get_pf(self):
        """The observed Pareto front: (X DataFrame, Y array)."""
        Y = self.y[:, : self.num_obj]
        ok = np.all(np.isfinite(Y), axis=1)
        mask = np.zeros(len(Y), bool)
        mask[ok] = pareto_mask(torch.as_tensor(Y[ok], dtype=torch.float32,
                                               device=self.device)).cpu().numpy()
        return self.X[mask], Y[mask]

    @property
    def best_y(self):
        if self.num_obj == 1:
            return super().best_y
        return self.get_pf()[1]
