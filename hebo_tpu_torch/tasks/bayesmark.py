"""Bayesmark-style sklearn hyperparameter suite and the challenge's score
(the port's own copy of ``hebo_tpu/tasks/bayesmark.py``).

Each task is an (sklearn model api_config, dataset, metric): the
api_configs follow Bayesmark's conventions (type real / int / bool / cat,
linear or log spacing), the datasets are sklearn's bundled ones (nothing is
downloaded), and a suggestion's loss is its k-fold cross-validated
1 − accuracy or MSE, on the host.  ``normalized_score`` is Bayesmark's
leaderboard normalization: 100 reaches the task optimum, 0 is no better
than random search.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import pandas as pd

from ..optimizers.util import parse_space_from_bayesmark

__all__ = ["BAYESMARK_API_CONFIGS", "BAYESMARK_DATASETS", "BayesmarkTask",
           "normalized_score", "suite"]


# --------------------------------------------------------------------------
# api_configs in Bayesmark's format ({name: {type, space, range|values}})
BAYESMARK_API_CONFIGS: Dict[str, dict] = {
    "DT": {
        "max_depth": {"type": "int", "space": "linear", "range": (1, 15)},
        "min_samples_split": {"type": "real", "space": "logit", "range": (0.01, 0.99)},
        "min_samples_leaf": {"type": "real", "space": "logit", "range": (0.01, 0.49)},
        "max_features": {"type": "real", "space": "logit", "range": (0.01, 0.99)},
    },
    "kNN": {
        "n_neighbors": {"type": "int", "space": "linear", "range": (1, 25)},
        "p": {"type": "int", "space": "linear", "range": (1, 4)},
    },
    "SVM": {
        "C": {"type": "real", "space": "log", "range": (1.0, 1e3)},
        "gamma": {"type": "real", "space": "log", "range": (1e-4, 1e-1)},
        "tol": {"type": "real", "space": "log", "range": (1e-5, 1e-1)},
    },
    "RF": {
        "n_estimators": {"type": "int", "space": "linear", "range": (10, 100)},
        "max_depth": {"type": "int", "space": "linear", "range": (1, 15)},
        "min_samples_split": {"type": "real", "space": "logit", "range": (0.01, 0.99)},
        "max_features": {"type": "real", "space": "logit", "range": (0.01, 0.99)},
    },
    "MLP": {
        "hidden_layer_sizes": {"type": "int", "space": "linear", "range": (16, 128)},
        "alpha": {"type": "real", "space": "log", "range": (1e-6, 1e1)},
        "learning_rate_init": {"type": "real", "space": "log", "range": (1e-5, 1e-1)},
        "tol": {"type": "real", "space": "log", "range": (1e-5, 1e-2)},
    },
    "ada": {
        "n_estimators": {"type": "int", "space": "linear", "range": (10, 100)},
        "learning_rate": {"type": "real", "space": "log", "range": (1e-4, 1e1)},
    },
    "lasso": {
        "alpha": {"type": "real", "space": "log", "range": (1e-6, 1e2)},
        "max_iter": {"type": "int", "space": "linear", "range": (100, 2000)},
    },
    "linear": {
        "alpha": {"type": "real", "space": "log", "range": (1e-6, 1e2)},
        "max_iter": {"type": "int", "space": "linear", "range": (100, 2000)},
    },
}


def _make_estimator(model: str, params: dict, classification: bool):
    from sklearn.ensemble import AdaBoostClassifier, AdaBoostRegressor
    from sklearn.ensemble import RandomForestClassifier, RandomForestRegressor
    from sklearn.linear_model import Lasso, LogisticRegression, Ridge
    from sklearn.neighbors import KNeighborsClassifier, KNeighborsRegressor
    from sklearn.neural_network import MLPClassifier, MLPRegressor
    from sklearn.svm import SVC, SVR
    from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

    p = dict(params)
    if model == "DT":
        cls = DecisionTreeClassifier if classification else DecisionTreeRegressor
        return cls(random_state=0, **p)
    if model == "kNN":
        cls = KNeighborsClassifier if classification else KNeighborsRegressor
        return cls(**p)
    if model == "SVM":
        return SVC(random_state=0, probability=False, **p) if classification else SVR(**p)
    if model == "RF":
        cls = RandomForestClassifier if classification else RandomForestRegressor
        return cls(random_state=0, **p)
    if model == "MLP":
        hls = int(p.pop("hidden_layer_sizes"))
        cls = MLPClassifier if classification else MLPRegressor
        return cls(hidden_layer_sizes=(hls,), random_state=0, max_iter=200, **p)
    if model == "ada":
        cls = AdaBoostClassifier if classification else AdaBoostRegressor
        return cls(random_state=0, **p)
    if model == "lasso":
        if classification:
            return LogisticRegression(
                penalty="elasticnet", l1_ratio=1.0, solver="saga",
                C=1.0 / max(p["alpha"], 1e-12),
                max_iter=int(p["max_iter"]), random_state=0,
            )
        return Lasso(alpha=p["alpha"], max_iter=int(p["max_iter"]), random_state=0)
    if model == "linear":
        if classification:
            return LogisticRegression(
                C=1.0 / max(p["alpha"], 1e-12), max_iter=int(p["max_iter"]), random_state=0,
            )
        return Ridge(alpha=p["alpha"], max_iter=int(p["max_iter"]), random_state=0)
    raise ValueError(f"unknown bayesmark model {model!r}")


def _load_dataset(name: str):
    from sklearn import datasets

    if name == "breast":
        d = datasets.load_breast_cancer()
        return d.data, d.target, True
    if name == "digits":
        d = datasets.load_digits()
        return d.data[:500], d.target[:500], True
    if name == "wine":
        d = datasets.load_wine()
        return d.data, d.target, True
    if name == "iris":
        d = datasets.load_iris()
        return d.data, d.target, True
    if name == "diabetes":
        d = datasets.load_diabetes()
        return d.data, d.target, False
    raise ValueError(f"unknown dataset {name!r}")


BAYESMARK_DATASETS = ("breast", "digits", "wine", "iris", "diabetes")


class BayesmarkTask:
    """One (model, dataset, metric) study.  Callable on a suggestion
    DataFrame; returns (n, 1) CV losses to MINIMIZE (1 - accuracy or MSE,
    Bayesmark's 'generalization' visible-to-optimizer loss)."""

    def __init__(self, model: str = "SVM", dataset: str = "breast",
                 n_splits: int = 3, seed: int = 0):
        self.model = model
        self.dataset = dataset
        self.api_config = BAYESMARK_API_CONFIGS[model]
        self.space = parse_space_from_bayesmark(self.api_config)
        self.n_splits = n_splits
        self.seed = seed
        self._X, self._y, self.classification = _load_dataset(dataset)

    @property
    def name(self) -> str:
        return f"{self.model}-{self.dataset}"

    def _coerce(self, row: dict) -> dict:
        """Pandas rows upcast mixed dtypes to float64; restore the
        api_config-declared types before handing params to sklearn."""
        out = {}
        for k, v in row.items():
            t = self.api_config.get(k, {}).get("type")
            if t == "int":
                out[k] = int(round(float(v)))
            elif t == "bool":
                out[k] = bool(v)
            elif t == "real":
                out[k] = float(v)
            else:
                out[k] = v
        return out

    def _eval_one(self, row: dict) -> float:
        import warnings

        from sklearn.model_selection import cross_val_score

        est = _make_estimator(self.model, self._coerce(row), self.classification)
        scoring = "accuracy" if self.classification else "neg_mean_squared_error"
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                s = cross_val_score(
                    est, self._X, self._y, cv=self.n_splits, scoring=scoring
                ).mean()
        except Exception:
            return float("inf")  # invalid configs observe as failures
        return float(1.0 - s) if self.classification else float(-s)

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        return np.asarray(
            [self._eval_one(dict(r)) for _, r in df.iterrows()], np.float64
        ).reshape(-1, 1)


def suite(models=("SVM", "DT", "kNN", "ada"), datasets=("breast", "diabetes")):
    return [BayesmarkTask(m, d) for m in models for d in datasets]


def normalized_score(best_opt: float, best_random: float, task_min: float) -> float:
    """Bayesmark leaderboard normalization: 100 = reached the (estimated)
    task optimum, 0 = no better than the random-search baseline."""
    denom = best_random - task_min
    if denom <= 1e-12:
        return 100.0
    return 100.0 * (1.0 - (best_opt - task_min) / denom)
