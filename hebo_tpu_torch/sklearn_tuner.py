"""sklearn hyperparameter tuner driven by HEBO (port of
``hebo_tpu/sklearn_tuner.py``): the k-fold cross-validated metric is the
black box, a suggestion's row becomes the estimator's keyword arguments,
and the best configuration comes back (with the history if ``report``).
``hebo_kw`` (``device=`` among them) go to HEBO.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import pandas as pd

from .design_space import DesignSpace
from .optimizers.hebo import HEBO

__all__ = ["sklearn_tuner"]


def sklearn_tuner(
    model_class,
    space_config: Sequence[dict],
    X: np.ndarray,
    y: np.ndarray,
    metric: Callable[[np.ndarray, np.ndarray], float],
    greater_is_better: bool = True,
    n_splits: int = 5,
    max_iter: int = 16,
    batch: int = 4,
    report: bool = False,
    hebo_kw: Optional[dict] = None,
):
    """Minimize (or maximize) a CV metric over a sklearn estimator's
    hyperparameters.  Returns best_params dict (and score history if
    ``report``)."""
    from sklearn.model_selection import KFold

    space = DesignSpace(space_config)
    opt = HEBO(space, **(hebo_kw or {}))
    sign = -1.0 if greater_is_better else 1.0

    def cv_score(row: Dict) -> float:
        kf = KFold(n_splits=n_splits, shuffle=True, random_state=0)
        scores = []
        for tr, te in kf.split(X):
            est = model_class(**row)
            est.fit(X[tr], np.asarray(y)[tr].ravel())
            pred = est.predict(X[te])
            scores.append(metric(np.asarray(y)[te].ravel(), pred))
        return float(np.mean(scores))

    history = []
    for _ in range(max_iter):
        rec = opt.suggest(batch)
        ys = []
        for _, r in rec.iterrows():
            row = {k: (v.item() if hasattr(v, "item") else v) for k, v in r.items()}
            ys.append(sign * cv_score(row))
        opt.observe(rec, np.asarray(ys).reshape(-1, 1))
        history.append(sign * opt.best_y)

    best = {
        k: (v.item() if hasattr(v, "item") else v)
        for k, v in opt.best_x.iloc[0].items()
    }
    if report:
        return best, np.asarray(history)
    return best
