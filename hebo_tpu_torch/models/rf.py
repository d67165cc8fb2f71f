"""Random-forest surrogate on the host (port of ``hebo_tpu/models/rf.py``).

sklearn's ``RandomForestRegressor``; the predictive variance is the
variance across trees plus an MSE-based noise estimate.  A copy of the JAX
package's host code: ``sklearn`` is imported inside ``fit``, so the package
imports where sklearn is not installed.  The forest takes no seed, as in
the JAX package (numpy's global state seeds it).  Like the JAX package's,
the model has no ``state``.
"""

from __future__ import annotations

import numpy as np

from ..utils.device import resolve_device
from .base import BaseModel, register_model

__all__ = ["RF"]


@register_model("rf")
class RF(BaseModel):
    support_ts = False

    def __init__(self, space, num_out=1, device="cuda", **conf):
        super().__init__(space, num_out, **conf)
        assert num_out == 1
        self.device = resolve_device(device)
        self.n_estimators = conf.get("n_estimators", 100)
        self._est = None
        self._noise_est = 0.0

    def _featurize(self, X):
        space = self.space
        parts = [np.asarray(X)[:, space.numeric_dims + space.perm_dims].astype(float)]
        for c in space.cat_dims:
            n = int(space.num_categories[c])
            oh = np.zeros((len(X), n))
            oh[np.arange(len(X)), np.asarray(X)[:, c].astype(int)] = 1.0
            parts.append(oh)
        return np.concatenate(parts, axis=1)

    def fit(self, X, y):
        from sklearn.ensemble import RandomForestRegressor

        y = np.asarray(y, float).reshape(len(X), 1)
        ok = np.isfinite(y[:, 0])
        F, yv = self._featurize(np.asarray(X)[ok]), y[ok, 0]
        self._est = RandomForestRegressor(n_estimators=self.n_estimators)
        self._est.fit(F, yv)
        self._noise_est = float(np.mean((self._est.predict(F) - yv) ** 2))
        return self

    def predict(self, X):
        F = self._featurize(X)
        preds = np.stack([t.predict(F) for t in self._est.estimators_])
        mu = preds.mean(axis=0)[:, None]
        var = preds.var(axis=0)[:, None] + self._noise_est + 1e-8
        return mu, var

    @property
    def noise(self):
        return np.asarray([self._noise_est])
