"""Synthetic benchmark suite: the port's own copy of ``hebo_tpu/tasks/synthetic.py`` (host numpy,
the same numbers).

Parity: reference benchmarks (HEBO/hebo/benchmarks/synthetic_benchmarks.py:
22-186): Ackley, Branin, Rosenbrock, Hartmann6, Styblinski-Tang, Schwefel,
plus noisy / dummy-dimension / offset variants, exposed with the ask/tell
DataFrame convention.  Evaluation is plain numpy (black boxes stay
host-side by design — SURVEY.md §7 "Host/device split").
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = [
    "SyntheticTask",
    "Ackley",
    "Branin",
    "Rosenbrock",
    "Hartmann6",
    "StyblinskiTang",
    "Schwefel",
    "Levy",
    "get_task",
]


class SyntheticTask:
    """Minimization task over a continuous box with optional noise /
    inactive dummy dims / input offset."""

    dim: int = 2
    lb: float = -1.0
    ub: float = 1.0
    fmin: float = 0.0

    def __init__(
        self,
        dim: Optional[int] = None,
        noise_std: float = 0.0,
        num_dummy: int = 0,
        offset: float = 0.0,
        rotate: bool = False,
        seed: int = 0,
    ):
        if dim is not None:
            self.dim = dim
        self.noise_std = noise_std
        self.num_dummy = num_dummy
        self.offset = offset
        self._rng = np.random.default_rng(seed)
        # offset-rotation variant (reference synthetic_benchmarks.py:22-186):
        # evaluate f(R·(x - offset)) for a fixed random rotation R
        self._rot = None
        if rotate:
            a = np.random.default_rng(seed + 1).standard_normal((self.dim, self.dim))
            q, _ = np.linalg.qr(a)
            self._rot = q

    @property
    def space(self) -> DesignSpace:
        total = self.dim + self.num_dummy
        return DesignSpace(
            [
                {"name": f"x{i}", "type": "num", "lb": self.lb, "ub": self.ub}
                for i in range(total)
            ]
        )

    def _f(self, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        X = df[[f"x{i}" for i in range(self.dim)]].values.astype(float)
        X = X - self.offset
        if self._rot is not None:
            # rotate about the box center, then clip back into the domain so
            # rotated evaluations stay within the function's defined region
            c = 0.5 * (self.lb + self.ub)
            X = np.clip((X - c) @ self._rot.T + c, self.lb, self.ub)
        y = self._f(X).reshape(-1, 1)
        if self.noise_std > 0:
            y = y + self.noise_std * self._rng.standard_normal(y.shape)
        return y


class Ackley(SyntheticTask):
    dim = 6
    lb, ub = -32.768, 32.768
    fmin = 0.0

    def _f(self, X):
        a, b, c = 20.0, 0.2, 2 * np.pi
        d = X.shape[1]
        s1 = np.sqrt(np.mean(X**2, axis=1))
        s2 = np.mean(np.cos(c * X), axis=1)
        return -a * np.exp(-b * s1) - np.exp(s2) + a + np.e


class Branin(SyntheticTask):
    dim = 2
    fmin = 0.397887

    @property
    def space(self):
        return DesignSpace(
            [
                {"name": "x0", "type": "num", "lb": -5.0, "ub": 10.0},
                {"name": "x1", "type": "num", "lb": 0.0, "ub": 15.0},
            ]
        )

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        a, b, c = 1.0, 5.1 / (4 * np.pi**2), 5.0 / np.pi
        r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
        return a * (y - b * x**2 + c * x - r) ** 2 + s * (1 - t) * np.cos(x) + s


class Rosenbrock(SyntheticTask):
    dim = 2
    lb, ub = -5.0, 10.0
    fmin = 0.0

    def _f(self, X):
        return np.sum(
            100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2 + (1 - X[:, :-1]) ** 2, axis=1
        )


class Hartmann6(SyntheticTask):
    dim = 6
    lb, ub = 0.0, 1.0
    fmin = -3.32237

    _A = np.array(
        [
            [10, 3, 17, 3.5, 1.7, 8],
            [0.05, 10, 17, 0.1, 8, 14],
            [3, 3.5, 1.7, 10, 17, 8],
            [17, 8, 0.05, 10, 0.1, 14],
        ]
    )
    _P = 1e-4 * np.array(
        [
            [1312, 1696, 5569, 124, 8283, 5886],
            [2329, 4135, 8307, 3736, 1004, 9991],
            [2348, 1451, 3522, 2883, 3047, 6650],
            [4047, 8828, 8732, 5743, 1091, 381],
        ]
    )
    _alpha = np.array([1.0, 1.2, 3.0, 3.2])

    def _f(self, X):
        inner = np.sum(self._A[None] * (X[:, None, :] - self._P[None]) ** 2, axis=2)
        return -np.sum(self._alpha[None] * np.exp(-inner), axis=1)


class StyblinskiTang(SyntheticTask):
    dim = 4
    lb, ub = -5.0, 5.0

    @property
    def fmin(self):
        return -39.16599 * self.dim

    def _f(self, X):
        return 0.5 * np.sum(X**4 - 16 * X**2 + 5 * X, axis=1)


class Schwefel(SyntheticTask):
    dim = 4
    lb, ub = -500.0, 500.0
    fmin = 0.0

    def _f(self, X):
        return 418.9829 * X.shape[1] - np.sum(X * np.sin(np.sqrt(np.abs(X))), axis=1)


class Levy(SyntheticTask):
    dim = 4
    lb, ub = -10.0, 10.0
    fmin = 0.0

    def _f(self, X):
        w = 1 + (X - 1) / 4.0
        t1 = np.sin(np.pi * w[:, 0]) ** 2
        t2 = np.sum(
            (w[:, :-1] - 1) ** 2 * (1 + 10 * np.sin(np.pi * w[:, :-1] + 1) ** 2),
            axis=1,
        )
        t3 = (w[:, -1] - 1) ** 2 * (1 + np.sin(2 * np.pi * w[:, -1]) ** 2)
        return t1 + t2 + t3


class Sphere(SyntheticTask):
    dim, lb, ub, fmin = 4, -5.0, 5.0, 0.0

    def _f(self, X):
        return np.sum(X**2, axis=1)


class SumSquares(SyntheticTask):
    dim, lb, ub, fmin = 4, -10.0, 10.0, 0.0

    def _f(self, X):
        return np.sum(np.arange(1, X.shape[1] + 1)[None] * X**2, axis=1)


class Rastrigin(SyntheticTask):
    dim, lb, ub, fmin = 4, -5.12, 5.12, 0.0

    def _f(self, X):
        return 10 * X.shape[1] + np.sum(X**2 - 10 * np.cos(2 * np.pi * X), axis=1)


class Griewank(SyntheticTask):
    dim, lb, ub, fmin = 4, -600.0, 600.0, 0.0

    def _f(self, X):
        i = np.sqrt(np.arange(1, X.shape[1] + 1))
        return 1 + np.sum(X**2, axis=1) / 4000 - np.prod(np.cos(X / i[None]), axis=1)


class Zakharov(SyntheticTask):
    dim, lb, ub, fmin = 4, -5.0, 10.0, 0.0

    def _f(self, X):
        s = np.sum(0.5 * np.arange(1, X.shape[1] + 1)[None] * X, axis=1)
        return np.sum(X**2, axis=1) + s**2 + s**4


class Michalewicz(SyntheticTask):
    dim, lb, ub = 4, 0.0, np.pi
    fmin = -3.0  # approx at dim 4

    def _f(self, X):
        i = np.arange(1, X.shape[1] + 1)
        return -np.sum(
            np.sin(X) * np.sin(i[None] * X**2 / np.pi) ** 20, axis=1
        )


class Powell(SyntheticTask):
    dim, lb, ub, fmin = 4, -4.0, 5.0, 0.0

    def _f(self, X):
        x1, x2, x3, x4 = X[:, 0], X[:, 1], X[:, 2], X[:, 3]
        return (
            (x1 + 10 * x2) ** 2 + 5 * (x3 - x4) ** 2
            + (x2 - 2 * x3) ** 4 + 10 * (x1 - x4) ** 4
        )


class DixonPrice(SyntheticTask):
    dim, lb, ub, fmin = 4, -10.0, 10.0, 0.0

    def _f(self, X):
        i = np.arange(2, X.shape[1] + 1)
        return (X[:, 0] - 1) ** 2 + np.sum(
            i[None] * (2 * X[:, 1:] ** 2 - X[:, :-1]) ** 2, axis=1
        )


class SixHumpCamel(SyntheticTask):
    dim, fmin = 2, -1.0316

    @property
    def space(self):
        return DesignSpace([
            {"name": "x0", "type": "num", "lb": -3.0, "ub": 3.0},
            {"name": "x1", "type": "num", "lb": -2.0, "ub": 2.0},
        ])

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return (4 - 2.1 * x**2 + x**4 / 3) * x**2 + x * y + (-4 + 4 * y**2) * y**2


class ThreeHumpCamel(SyntheticTask):
    dim, lb, ub, fmin = 2, -5.0, 5.0, 0.0

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return 2 * x**2 - 1.05 * x**4 + x**6 / 6 + x * y + y**2


class Beale(SyntheticTask):
    dim, lb, ub, fmin = 2, -4.5, 4.5, 0.0

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return (
            (1.5 - x + x * y) ** 2
            + (2.25 - x + x * y**2) ** 2
            + (2.625 - x + x * y**3) ** 2
        )


class Booth(SyntheticTask):
    dim, lb, ub, fmin = 2, -10.0, 10.0, 0.0

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return (x + 2 * y - 7) ** 2 + (2 * x + y - 5) ** 2


class Matyas(SyntheticTask):
    dim, lb, ub, fmin = 2, -10.0, 10.0, 0.0

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return 0.26 * (x**2 + y**2) - 0.48 * x * y


class GoldsteinPrice(SyntheticTask):
    dim, lb, ub, fmin = 2, -2.0, 2.0, 3.0

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        a = 1 + (x + y + 1) ** 2 * (
            19 - 14 * x + 3 * x**2 - 14 * y + 6 * x * y + 3 * y**2
        )
        b = 30 + (2 * x - 3 * y) ** 2 * (
            18 - 32 * x + 12 * x**2 + 48 * y - 36 * x * y + 27 * y**2
        )
        return a * b


class Easom(SyntheticTask):
    dim, lb, ub, fmin = 2, -100.0, 100.0, -1.0

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return -np.cos(x) * np.cos(y) * np.exp(-((x - np.pi) ** 2 + (y - np.pi) ** 2))


class Bohachevsky(SyntheticTask):
    dim, lb, ub, fmin = 2, -100.0, 100.0, 0.0

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return (
            x**2 + 2 * y**2 - 0.3 * np.cos(3 * np.pi * x)
            - 0.4 * np.cos(4 * np.pi * y) + 0.7
        )


class McCormick(SyntheticTask):
    dim, fmin = 2, -1.9133

    @property
    def space(self):
        return DesignSpace([
            {"name": "x0", "type": "num", "lb": -1.5, "ub": 4.0},
            {"name": "x1", "type": "num", "lb": -3.0, "ub": 4.0},
        ])

    def _f(self, X):
        x, y = X[:, 0], X[:, 1]
        return np.sin(x + y) + (x - y) ** 2 - 1.5 * x + 2.5 * y + 1


# SFU-suite registry (parity: MCBO/mcbo/tasks/synthetic/sfu/, 21 functions)
_TASKS = {
    "ackley": Ackley,
    "branin": Branin,
    "rosenbrock": Rosenbrock,
    "hartmann6": Hartmann6,
    "styblinski_tang": StyblinskiTang,
    "schwefel": Schwefel,
    "levy": Levy,
    "sphere": Sphere,
    "sum_squares": SumSquares,
    "rastrigin": Rastrigin,
    "griewank": Griewank,
    "zakharov": Zakharov,
    "michalewicz": Michalewicz,
    "powell": Powell,
    "dixon_price": DixonPrice,
    "six_hump_camel": SixHumpCamel,
    "three_hump_camel": ThreeHumpCamel,
    "beale": Beale,
    "booth": Booth,
    "matyas": Matyas,
    "goldstein_price": GoldsteinPrice,
    "easom": Easom,
    "bohachevsky": Bohachevsky,
    "mccormick": McCormick,
}


def get_task(name: str, **kw) -> SyntheticTask:
    return _TASKS[name](**kw)
