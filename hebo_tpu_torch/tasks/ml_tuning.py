"""ML hyperparameter-tuning tasks: SVM and gradient-boosting (XGBoost-style): the port's own copy of ``hebo_tpu/tasks/ml_tuning.py`` (host numpy,
the same numbers).

Parity: MCBO's XGBoost / SVM tuning tasks (mcbo/tasks/, task_factory.py:16-97)
— tune a real sklearn estimator by k-fold cross-validation on a small
dataset.  The black box runs host-side (CPU, sklearn); only the BO loop is
on device, matching the host/device split the framework uses everywhere
(SURVEY.md §7 "Host/device split").

``xgboost`` is optional, so the boosting task uses sklearn's
``HistGradientBoostingRegressor`` (same algorithm family and the same
hyperparameter surface: learning rate, depth, leaf counts, regularisation);
if ``xgboost`` happens to be importable it is used instead.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = ["SVMTuningTask", "XGBTuningTask"]


def _toy_regression(n: int = 256, d: int = 8, seed: int = 0):
    """Deterministic synthetic regression set (keeps tests hermetic)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, size=(n, d))
    y = (
        np.sin(3.0 * X[:, 0]) * X[:, 1]
        + 0.5 * X[:, 2] ** 2
        - X[:, 3] * X[:, 4]
        + 0.1 * rng.standard_normal(n)
    )
    return X, y


class _CVTask:
    """Shared k-fold CV harness; subclasses provide space + estimator.

    Every fold fit is bounded: estimators must be constructed with finite
    iteration caps (see ``SVMTuningTask._make_estimator`` — libsvm's default
    ``max_iter=-1`` can spin unboundedly on ill-conditioned configs), and a
    wall-clock guard maps any evaluation exceeding ``eval_timeout_s`` to inf
    so the BO loop observes a failure instead of hanging.
    """

    #: per-configuration wall-clock budget (whole CV, all folds)
    eval_timeout_s: float = 60.0

    def __init__(self, X=None, y=None, n_folds: int = 3, seed: int = 0):
        if X is None:
            X, y = _toy_regression(seed=seed)
        self.X = np.asarray(X, float)
        self.y = np.asarray(y, float).ravel()
        self.n_folds = int(n_folds)
        self.seed = int(seed)

    def _make_estimator(self, params: dict):
        raise NotImplementedError

    def _cv_rmse(self, params: dict) -> float:
        import time

        from sklearn.model_selection import KFold

        kf = KFold(n_splits=self.n_folds, shuffle=True, random_state=self.seed)
        t0 = time.monotonic()
        errs = []
        for tr, te in kf.split(self.X):
            est = self._make_estimator(params)
            import warnings

            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # ConvergenceWarning from capped iters
                est.fit(self.X[tr], self.y[tr])
            pred = est.predict(self.X[te])
            err = float(np.sqrt(np.mean((pred - self.y[te]) ** 2)))
            if not np.isfinite(err):
                return float("inf")
            errs.append(err)
            if time.monotonic() - t0 > self.eval_timeout_s:
                # Over budget: charge the config as a failure rather than
                # letting one pathological fold stall the whole suite.
                return float("inf")
        return float(np.mean(errs))

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        ys = []
        for _, row in df.iterrows():
            try:
                ys.append(self._cv_rmse(row.to_dict()))
            except Exception:
                ys.append(float("inf"))  # bad configs observed as inf (filtered)
        return np.asarray(ys, float).reshape(-1, 1)


class SVMTuningTask(_CVTask):
    """Tune an RBF/poly SVR: C, gamma, epsilon, kernel.

    Parity: MCBO SVM tuning task (mixed space: log-scale continuous +
    categorical kernel choice).
    """

    @property
    def space(self) -> DesignSpace:
        return DesignSpace().parse([
            {"name": "C", "type": "pow", "lb": 1e-2, "ub": 1e3},
            {"name": "gamma", "type": "pow", "lb": 1e-4, "ub": 10.0},
            {"name": "epsilon", "type": "pow", "lb": 1e-3, "ub": 1.0},
            {"name": "kernel", "type": "cat", "categories": ["rbf", "poly", "sigmoid"]},
        ])

    def _make_estimator(self, params):
        from sklearn.svm import SVR

        # libsvm's default max_iter=-1 never terminates on some (C, gamma,
        # kernel=poly) corners (e.g. C≈179, gamma≈4.5 spins >60 s/fold on 171
        # points).  Cap iterations and let _cv_rmse map the resulting poor /
        # non-finite fit to a high RMSE — the BO loop treats it as a bad
        # config, mirroring the reference's observed-as-inf convention.
        return SVR(
            C=float(params["C"]),
            gamma=float(params["gamma"]),
            epsilon=float(params["epsilon"]),
            kernel=str(params["kernel"]),
            max_iter=20_000,
        )


class XGBTuningTask(_CVTask):
    """Tune a gradient-boosted-tree regressor (XGBoost-style surface).

    Parity: MCBO XGBoost tuning task — learning rate (log), max depth,
    leaf count, L2 regularisation, subsample-ish controls.
    """

    @property
    def space(self) -> DesignSpace:
        return DesignSpace().parse([
            {"name": "learning_rate", "type": "pow", "lb": 1e-3, "ub": 1.0},
            {"name": "max_depth", "type": "int", "lb": 1, "ub": 10},
            {"name": "max_leaf_nodes", "type": "int", "lb": 2, "ub": 64},
            {"name": "l2_regularization", "type": "pow", "lb": 1e-8, "ub": 10.0},
            {"name": "max_iter", "type": "step_int", "lb": 20, "ub": 200, "step": 20},
        ])

    def _make_estimator(self, params):
        try:  # real xgboost if installed
            from xgboost import XGBRegressor  # pragma: no cover

            return XGBRegressor(
                learning_rate=float(params["learning_rate"]),
                max_depth=int(params["max_depth"]),
                max_leaves=int(params["max_leaf_nodes"]),
                reg_lambda=float(params["l2_regularization"]),
                n_estimators=int(params["max_iter"]),
            )
        except ImportError:
            from sklearn.ensemble import HistGradientBoostingRegressor

            return HistGradientBoostingRegressor(
                learning_rate=float(params["learning_rate"]),
                max_depth=int(params["max_depth"]),
                max_leaf_nodes=int(params["max_leaf_nodes"]),
                l2_regularization=float(params["l2_regularization"]),
                max_iter=int(params["max_iter"]),
                random_state=self.seed,
            )
