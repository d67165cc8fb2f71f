"""NoMR: explore with HEBO until the best objective drops below η, then
exploit with a low-κ ``BO`` (port of ``hebo_tpu/optimizers/nomr.py``)."""

from __future__ import annotations

import torch

from ..acquisitions.acq import Acquisition
from .base import AbstractOptimizer
from .bo import BO
from .hebo import HEBO

__all__ = ["AbsEtaDifference", "NoMR_BO"]


class AbsEtaDifference(Acquisition):
    """|μ − η| − κσ: seeks points whose value matches the target η."""

    def __init__(self, eta: float = 0.0, kappa: float = 0.6):
        self.eta = eta
        self.kappa = kappa

    def eval_pure(self, model, state, params, X):
        mu, var = model.predict_pure(state, X)
        sigma = torch.sqrt(torch.clamp(var, min=1e-12))
        return torch.abs(mu - self.eta) - self.kappa * sigma


class NoMR_BO(AbstractOptimizer):
    """``stage1`` (HEBO) serves every suggest until an observation falls
    below ``eta``; from then on ``stage2`` (BO with κ = ``kappa_exploit``)
    does.  ``exploiting`` says which."""

    def __init__(self, space, eta: float = 0.0, kappa_exploit: float = 0.6, **kw):
        super().__init__(space, kw.pop("csv_save_path", None))
        self.eta = eta
        self.stage1 = HEBO(space, **kw)
        self.stage2 = BO(space, kappa=kappa_exploit, **kw)
        self._exploiting = False

    @property
    def exploiting(self) -> bool:
        return self._exploiting

    def method_suggest(self, n_suggestions=1, fix_input=None):
        stage = self.stage2 if self._exploiting else self.stage1
        return stage.method_suggest(n_suggestions, fix_input)

    def observe_new_data(self, Xdf, y):
        for stage in (self.stage1, self.stage2):
            stage.X, stage.y = self.X, self.y
        if not self._exploiting and self.best_y < self.eta:
            self._exploiting = True
