"""Vanilla BO (port of ``hebo_tpu/optimizers/bo.py``): a Sobol init phase,
a GP fitted on standardized y, a fixed-κ LCB minimized by ``EvolutionOpt``
(NSGA-II with one objective: K5 at (pop, 1) and (2·pop, 1) on the card)
from the incumbent, one suggestion per call; ``suggest(n > 1)`` returns
Sobol points, as in the JAX package (bo.py:48).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..acq_optimizers.evolution import EvolutionOpt
from ..acquisitions.acq import LCB, AcqParams
from ..models import get_model
from ..utils.device import resolve_device
from .base import AbstractOptimizer, timed

__all__ = ["BO"]


class BO(AbstractOptimizer):
    def __init__(
        self,
        space,
        model_name: str = "gp",
        rand_sample: Optional[int] = None,
        kappa: float = 2.0,
        model_config: Optional[dict] = None,
        pop: int = 100,
        iters: int = 100,
        csv_save_path: Optional[str] = None,
        device="cuda",
    ):
        super().__init__(space, csv_save_path)
        self.device = resolve_device(device)
        self.model_name = model_name
        self.rand_sample = rand_sample if rand_sample is not None else 1 + space.num_cols
        self.kappa = kappa
        self.model_config = model_config or {}
        self.pop = pop
        self.iters = iters
        self.model = None
        self._evo = None
        self._acq = LCB()
        self._sobol_count = 0

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.num_obs < self.rand_sample or n_suggestions > 1:
            X = self.space.sobol_sample_opt(n_suggestions, seed=self._sobol_count)
            self._sobol_count += 1
            return _fix(self.space.inverse_transform(X), fix_input)

        X = self.space.transform(self.X)
        y = self.y[:, :1].copy()
        ok = np.isfinite(y[:, 0])
        Xv, yv = X[ok], y[ok]
        ys = (yv - yv.mean()) / max(yv.std(), 1e-12)

        if self.model is None:
            self.model = get_model(self.model_name, self.space, num_out=1, device=self.device,
                                   **self.model_config)
        with timed(self.fit_time, self.device):
            self.model.fit(Xv, ys)

        if self._evo is None:
            self._evo = EvolutionOpt(self.space, self._acq, pop=self.pop, iters=self.iters)
        best_id = int(np.argmin(ys[:, 0]))
        with timed(self.acq_time, self.device):
            rec = self._evo.optimize(model=self.model, acq_params=AcqParams(kappa=self.kappa),
                                     initial_suggest=Xv[best_id : best_id + 1],
                                     fix_input=fix_input, seed=self.num_obs)
        return _fix(self.space.inverse_transform(rec), fix_input)


def _fix(df, fix_input):
    for k, v in (fix_input or {}).items():
        df[k] = v
    return df
