"""Per-evaluation results logging (copy of ``hebo_tpu/utils/results_logger.py``).

Parity: MCBO ``ResultsLogger`` / ``ResultsLoggerV2``
(MCBO/mcbo/utils/results_logger.py:9-144): per-eval rows with suggest /
observe / eval wall-clock columns, CSV + pickle persistence — and the
AntBO result-CSV schema (`Num BB Evals, Suggest Time, ... Best Binding
Energy`, AntBO/results_data/HEBO_optim_res.csv).
"""

from __future__ import annotations

import json
import os
import pickle
import time
from typing import Optional

import numpy as np
import pandas as pd

__all__ = ["ResultsLogger"]


class ResultsLogger:
    COLUMNS = [
        "Eval Idx",
        "Num BB Evals",
        "Suggest Time",
        "Observe Time",
        "Eval Time",
        "y",
        "Best y",
        "Timestamp",
    ]

    def __init__(self, save_path: Optional[str] = None):
        self.save_path = save_path
        self.rows = []
        self._best = np.inf

    def append(
        self,
        y,
        suggest_time: float = 0.0,
        observe_time: float = 0.0,
        eval_time: float = 0.0,
        x_row: Optional[dict] = None,
    ):
        y = np.atleast_1d(np.asarray(y, float)).ravel()
        for yi in y:
            if np.isfinite(yi):
                self._best = min(self._best, float(yi))
            row = {
                "Eval Idx": len(self.rows),
                "Num BB Evals": len(self.rows) + 1,
                "Suggest Time": suggest_time / max(len(y), 1),
                "Observe Time": observe_time / max(len(y), 1),
                "Eval Time": eval_time / max(len(y), 1),
                "y": float(yi),
                "Best y": self._best if np.isfinite(self._best) else np.nan,
                "Timestamp": time.time(),
            }
            if x_row:
                row.update(x_row)
            self.rows.append(row)
        if self.save_path:
            self.save()

    @property
    def frame(self) -> pd.DataFrame:
        return pd.DataFrame(self.rows)

    def save(self, path: Optional[str] = None):
        path = path or self.save_path
        assert path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.frame.to_csv(path, index=False)
        with open(path + ".pkl", "wb") as f:
            pickle.dump(self.rows, f)

    @classmethod
    def load(cls, path: str) -> "ResultsLogger":
        lg = cls(save_path=path)
        with open(path + ".pkl", "rb") as f:
            lg.rows = pickle.load(f)
        ys = [r["y"] for r in lg.rows if np.isfinite(r["y"])]
        lg._best = min(ys) if ys else np.inf
        return lg
