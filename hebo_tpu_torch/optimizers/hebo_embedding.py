"""Random-embedding high-dimensional HEBO (port of
``hebo_tpu/optimizers/hebo_embedding.py``): HEBO runs in a ``eff_dim``
box [−scale, scale]^d, and each suggestion is projected up, x = mid +
half·clip(A z, −1, 1).  The projection (``alebo``: column-normalized
Gaussian; ``hesbo``: a ±1 count sketch) is host numpy from
``np.random.default_rng(seed)``, bit-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..design_space import DesignSpace
from .hebo import HEBO

__all__ = ["HEBO_Embedding", "gen_proj_matrix", "gen_emb_space"]


def gen_proj_matrix(D_hi: int, D_lo: int, strategy: str = "alebo", seed: int = 0) -> np.ndarray:
    """(D_hi, D_lo) projection: x_hi = A @ x_lo."""
    rng = np.random.default_rng(seed)
    if strategy == "alebo":
        A = rng.standard_normal((D_hi, D_lo))
        A /= np.linalg.norm(A, axis=0, keepdims=True)
        return A
    if strategy == "hesbo":
        A = np.zeros((D_hi, D_lo))
        h = rng.integers(0, D_lo, size=D_hi)
        s = rng.choice([-1.0, 1.0], size=D_hi)
        A[np.arange(D_hi), h] = s
        return A
    raise ValueError(f"unknown strategy {strategy!r}")


def gen_emb_space(D_lo: int, scale: float = 1.0) -> DesignSpace:
    return DesignSpace([{"name": f"z{i}", "type": "num", "lb": -scale, "ub": scale}
                        for i in range(D_lo)])


class HEBO_Embedding:
    """HEBO in a ``eff_dim``-dimensional embedding of a continuous space;
    ``hebo_kw`` (``device=`` among them) go to the inner HEBO."""

    def __init__(self, space: DesignSpace, eff_dim: int = 8, strategy: str = "alebo",
                 scale: float = 1.0, seed: int = 0, **hebo_kw):
        if space.cat_dims:
            raise ValueError("embedding BO supports continuous spaces")
        self.space = space
        self.D_hi = space.num_cols
        self.eff_dim = eff_dim
        self.A = gen_proj_matrix(self.D_hi, eff_dim, strategy, seed)
        self.emb_space = gen_emb_space(eff_dim, scale)
        self.opt = HEBO(self.emb_space, **hebo_kw)
        self._lb = space.opt_lb
        self._ub = space.opt_ub

    def _project_up(self, Z: np.ndarray) -> np.ndarray:
        mid = 0.5 * (self._lb + self._ub)
        half = 0.5 * (self._ub - self._lb)
        return mid + half * np.clip(Z @ self.A.T, -1.0, 1.0)

    def suggest(self, n_suggestions: int = 1) -> pd.DataFrame:
        zrec = self.opt.suggest(n_suggestions)
        self._z_pending = zrec
        return self.space.inverse_transform(self._project_up(self.emb_space.transform(zrec)))

    def observe(self, X: pd.DataFrame, y: np.ndarray):
        self.opt.observe(self._z_pending, y)

    @property
    def best_y(self):
        return self.opt.best_y

    @property
    def y(self):
        return self.opt.y
