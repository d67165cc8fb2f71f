"""Append-only observation store (copy of ``hebo_tpu/utils/data_buffer.py``).

Parity: MCBO ``DataBuffer`` (MCBO/mcbo/utils/data_buffer.py:9-141):
x/y tensor store with objective + constraint columns, best-point queries.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["DataBuffer"]


class DataBuffer:
    def __init__(self, num_dims: int, num_obj: int = 1, num_constr: int = 0):
        self.num_dims = num_dims
        self.num_obj = num_obj
        self.num_constr = num_constr
        self._x = np.zeros((0, num_dims))
        self._y = np.zeros((0, num_obj + num_constr))

    def append(self, x: np.ndarray, y: np.ndarray):
        x = np.atleast_2d(np.asarray(x, float))
        y = np.atleast_2d(np.asarray(y, float))
        assert x.shape[1] == self.num_dims
        assert y.shape[1] == self.num_obj + self.num_constr
        assert len(x) == len(y)
        self._x = np.vstack([self._x, x])
        self._y = np.vstack([self._y, y])

    def __len__(self):
        return len(self._x)

    @property
    def x(self) -> np.ndarray:
        return self._x

    @property
    def y(self) -> np.ndarray:
        return self._y[:, : self.num_obj]

    @property
    def constraints(self) -> np.ndarray:
        return self._y[:, self.num_obj :]

    @property
    def feasible(self) -> np.ndarray:
        if self.num_constr == 0:
            return np.ones(len(self), bool)
        return np.all(self.constraints <= 0, axis=1)

    def best(self) -> Tuple[Optional[np.ndarray], Optional[float]]:
        """Best feasible (x, y0); (None, None) if nothing feasible."""
        ok = self.feasible & np.isfinite(self.y[:, 0])
        if not np.any(ok):
            return None, None
        idx = np.where(ok)[0]
        b = idx[int(np.argmin(self.y[ok, 0]))]
        return self._x[b], float(self.y[b, 0])

    def state_dict(self) -> dict:
        return {"x": self._x.copy(), "y": self._y.copy()}

    def load_state_dict(self, d: dict):
        self._x = np.asarray(d["x"], float)
        self._y = np.asarray(d["y"], float)
