"""Surrogate model base class + registry (port of ``hebo_tpu/models/base.py``).

``fit``/``predict`` take the flat opt-frame array ``X (n, D)`` of the design
space; models receive the static column metadata at construction.
``get_model("multi_task", ...)`` builds a ``MultiTaskModel``: one
single-output model per output column (base.py:77-122).
"""

from __future__ import annotations

from typing import Dict, Tuple, Type

import numpy as np
import torch

__all__ = ["BaseModel", "MODEL_REGISTRY", "register_model", "get_model", "get_model_class",
           "MultiTaskModel"]


class BaseModel:
    support_ts: bool = False
    support_grad: bool = False
    support_multi_output: bool = False
    support_warm_start: bool = False

    def __init__(self, space, num_out: int = 1, **conf):
        self.space = space
        self.num_out = num_out
        self.conf = conf

    def fit(self, X: np.ndarray, y: np.ndarray) -> "BaseModel":
        raise NotImplementedError

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Return (mu, var), each (n, num_out)."""
        raise NotImplementedError

    def sample_y(self, X: np.ndarray, n_samples: int = 20, seed: int = 0) -> np.ndarray:
        """Posterior-predictive draws (n_samples, n, num_out)."""
        mu, var = self.predict(X)
        rng = np.random.default_rng(seed)
        return mu[None] + np.sqrt(np.maximum(var[None], 0)) * rng.standard_normal(
            (n_samples,) + mu.shape
        )

    def sample_f(self):
        """A deterministic function drawn from the posterior (Thompson
        sampling); only where ``support_ts``."""
        raise NotImplementedError

    @property
    def noise(self) -> np.ndarray:
        return np.zeros(self.num_out)


MODEL_REGISTRY: Dict[str, Type[BaseModel]] = {}


def register_model(name: str):
    def deco(cls):
        MODEL_REGISTRY[name] = cls
        cls.model_name = name
        return cls

    return deco


def get_model_class(name: str) -> Type[BaseModel]:
    if name not in MODEL_REGISTRY:
        raise ValueError(f"Unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def get_model(name: str, space, num_out: int = 1, **conf) -> BaseModel:
    """The registered model ``name``; ``multi_task`` wraps one
    ``base_model_name`` model (default ``gp``) per output."""
    if name == "multi_task":
        base = conf.pop("base_model_name", "gp")
        return MultiTaskModel(space, num_out=num_out, base_model_name=base, **conf)
    return get_model_class(name)(space, num_out=num_out, **conf)


class MultiTaskModel(BaseModel):
    """One independent single-output model per output column, each fitted
    on its own column (and normalizing it on its own); ``state`` is the
    tuple of the members' states and ``predict_pure`` concatenates their
    (mu, var) along the output axis."""

    support_multi_output = True

    def __init__(self, space, num_out: int = 1, base_model_name: str = "gp", **conf):
        super().__init__(space, num_out=num_out)
        self.models = [get_model(base_model_name, space, num_out=1, **conf)
                       for _ in range(num_out)]
        self.device = getattr(self.models[0], "device", None)

    def fit(self, X, y):
        y = np.asarray(y).reshape(len(X), self.num_out)
        for i, m in enumerate(self.models):
            m.fit(X, y[:, i : i + 1])
        return self

    def predict(self, X):
        mus, vars_ = zip(*[m.predict(X) for m in self.models])
        return np.concatenate(mus, axis=-1), np.concatenate(vars_, axis=-1)

    @property
    def state(self):
        return tuple(m.state for m in self.models)

    def predict_pure(self, states, Xs):
        outs = [m.predict_pure(s, Xs) for m, s in zip(self.models, states)]
        return torch.cat([o[0] for o in outs], -1), torch.cat([o[1] for o in outs], -1)

    @property
    def noise(self):
        return np.concatenate([m.noise for m in self.models])
