"""MACEBO: HEBO behind the Bayesmark protocol of the NeurIPS-2020 BBO
challenge (port of ``hebo_tpu/optimizers/macebo.py``): Bayesmark hands the
optimizer an ``api_config`` and calls ``suggest(n) -> [{param: value}, ...]``
and ``observe(guesses, losses)``.  This class only adapts the frame
(api_config → DesignSpace, list of dicts ⇄ DataFrame); ``hebo_kwargs``
(``device=`` among them) go to the HEBO underneath.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import pandas as pd

from .hebo import HEBO
from .util import parse_space_from_bayesmark

__all__ = ["MACEBO"]


class MACEBO:
    primary_import = "hebo_tpu_torch"

    def __init__(self, api_config: Dict[str, dict], **hebo_kwargs):
        self.api_config = api_config
        self.space = parse_space_from_bayesmark(api_config)
        self.opt = HEBO(self.space, **hebo_kwargs)

    def suggest(self, n_suggestions: int = 1) -> List[dict]:
        rec = self.opt.suggest(n_suggestions)
        out = []
        for _, row in rec.iterrows():
            guess = {}
            for name, cfg in self.api_config.items():
                v = row[name]
                if cfg["type"] == "int":
                    v = int(round(float(v)))
                elif cfg["type"] == "bool":
                    v = bool(int(round(float(v))))
                elif cfg["type"] == "real":
                    v = float(v)
                guess[name] = v
            out.append(guess)
        return out

    def observe(self, X: Sequence[dict], y: Sequence[float]) -> None:
        df = pd.DataFrame(list(X))
        yv = np.asarray(list(y), dtype=float).reshape(-1, 1)
        # Bayesmark reports non-finite losses for crashed configs; HEBO's
        # observe path filters them (reference filter_nan, models/util.py:6-18)
        self.opt.observe(df, yv)

    @property
    def best_x(self):
        return self.opt.best_x

    @property
    def best_y(self):
        return self.opt.best_y
