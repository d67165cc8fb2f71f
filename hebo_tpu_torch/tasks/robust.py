"""Robust-BO benchmark problems (AIRBO task family): the port's own copy of ``hebo_tpu/tasks/robust.py`` (host numpy,
the same numbers).

Parity: AIRBO (its problems/ package):
  * ``rkhs_synth`` — the published RKHS heteroscedastic test function
    (rkhs.py:46-68, Assael/Wang/de Freitas): a sum of two SE-kernel RBF
    expansions with fixed support points; global max f(0.89235)=5.73839.
    Re-implemented from the published formula.
  * corruption wrappers (test_function.py:13-56): square-wave-gated
    sawtooth corruption added to a base objective, "small"/"large"
    presets — used to stress-test robustness under input perturbation.
  * robot pushing (robot_pushing/push_world.py, push_env.py): the
    reference drives a Box2D + pygame rigid-body world.  Neither library
    is a dependency here, and a physics engine on the host would sit
    outside the device compute path anyway — so this module provides a
    deterministic kinematic push model with the same interface shape
    (hand position + push duration [+ push angle] in, distance-to-goal
    out) and the same benchmark role (a cheap, rugged, non-convex
    objective whose value is sensitive to execution noise on the
    inputs).  It is a fresh design, not a Box2D port.
  * ``UncertainEvalWrapper`` — evaluates a task under execution noise
    x + eps (common random numbers per call index), the input-uncertainty
    protocol AIRBO's experiments use with the uncertain-input GP
    (``models/gp/uncertain_gp.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = [
    "rkhs_synth",
    "RKHSTask",
    "small_corruption",
    "large_corruption",
    "CorruptedTask",
    "RobotPushTask",
    "UncertainEvalWrapper",
]


# --------------------------------------------------------------------- RKHS
_SUPPORT_WIDE = np.asarray([0.1, 0.15, 0.08, 0.3, 0.4])
_VALS_WIDE = np.asarray([4.0, -1.0, 2.0, -2.0, 1.0])
_SUPPORT_NARROW = np.asarray(
    [0.8, 0.85, 0.9, 0.95, 0.92, 0.74, 0.91, 0.89, 0.79, 0.88, 0.86, 0.96, 0.99, 0.82]
)
_VALS_NARROW = np.asarray(
    [3.0, 4.0, 2.0, 1.0, -1.0, 2.0, 2.0, 3.0, 3.0, 2.0, -1.0, -2.0, 4.0, -3.0]
)


def rkhs_synth(x: np.ndarray) -> np.ndarray:
    """RKHS test function on [0, 1] (maximum ≈ 5.738 at x ≈ 0.892).

    f(x) = Σ v_i k_0.1(s_i, x) + Σ w_j k_0.01(t_j, x) with SE kernels of
    lengthscales 0.1 (wide component) and 0.01 (narrow component).
    """
    x = np.asarray(x, float).reshape(-1, 1)
    d_w = (x - _SUPPORT_WIDE[None, :]) / 0.1
    d_n = (x - _SUPPORT_NARROW[None, :]) / 0.01
    f = np.exp(-0.5 * d_w**2) @ _VALS_WIDE + np.exp(-0.5 * d_n**2) @ _VALS_NARROW
    return f


class RKHSTask:
    """Minimization wrapper (returns -f) over x ∈ [0, 1]."""

    fmin = -5.73839  # -global max

    @property
    def space(self) -> DesignSpace:
        return DesignSpace([{"name": "x", "type": "num", "lb": 0.0, "ub": 1.0}])

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        return -rkhs_synth(df["x"].values).reshape(-1, 1)


# --------------------------------------------------------------- corruption
def _square(t: np.ndarray) -> np.ndarray:
    return np.where(np.sin(t) >= 0.0, 1.0, -1.0)


def _sawtooth(t: np.ndarray) -> np.ndarray:
    return 2.0 * (t / (2 * np.pi) - np.floor(0.5 + t / (2 * np.pi)))


_CORRUPTION_PRESETS = {
    "small": (0.2, 0.2, 0.2, 0.2),
    "large": (0.5, 0.5, 0.5, 0.5),
}


def _corruption(x: np.ndarray, amps: Sequence[float]) -> np.ndarray:
    """Square-wave-gated multi-frequency sawtooth ripple on [0, 1]."""
    x = np.asarray(x, float)
    gate = (1.0 * _square(4 * 2 * np.pi * x)) * (
        0.5 + 0.5 * _square(4 * 2 * np.pi * x)
    )
    phases = (0.3 * np.pi, 0.0, np.pi, 0.5 * np.pi)
    freqs = (15, 10, 30, 40)
    ripple = sum(
        a * _sawtooth(p + f * 2 * np.pi * x)
        for a, p, f in zip(amps, phases, freqs)
    )
    return gate * ripple


def small_corruption(x: np.ndarray) -> np.ndarray:
    return _corruption(x, _CORRUPTION_PRESETS["small"])


def large_corruption(x: np.ndarray) -> np.ndarray:
    return _corruption(x, _CORRUPTION_PRESETS["large"])


class CorruptedTask:
    """Adds normalized corruption to a base task's objective.

    Each input column is normalized to [0, 1] over the space box and the
    corruption of the first column is scaled by ``scale`` × the base
    objective's range proxy — mirroring ``add_corruption``
    (test_function.py:49-56).
    """

    def __init__(self, base, corruption: str = "small", scale: float = 1.0):
        self.base = base
        self.corr: Callable = (
            small_corruption if corruption == "small" else large_corruption
        )
        self.scale = scale

    @property
    def space(self) -> DesignSpace:
        return self.base.space

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        y = np.asarray(self.base(df), float)
        sp = self.space
        X = sp.transform(df).astype(float)
        lb, ub = sp.opt_lb, sp.opt_ub
        xn = (X[:, 0] - lb[0]) / max(ub[0] - lb[0], 1e-12)
        return y + self.scale * self.corr(np.clip(xn, 0.0, 1.0)).reshape(-1, 1)


# ------------------------------------------------------------- robot push
class RobotPushTask:
    """Kinematic push-to-goal benchmark (3-D or 4-D input).

    Inputs: hand start (rx, ry) ∈ [-5, 5]², push duration t ∈ [1, 30]
    (and, for dim=4, a push-angle offset ϕ ∈ [-π/4, π/4]).  The hand
    moves toward the object at the origin (direction rotated by ϕ),
    contacts the unit-radius puck, and transfers momentum for the
    remaining duration; the puck decelerates under Coulomb-like friction
    (quadratic distance-in-time profile, capped by the momentum
    transferred).  Objective: final distance of the puck to ``goal``.

    Deterministic, non-convex (goal reachable only for the right
    direction/duration combinations), and sharply sensitive to input
    perturbation — the property the AIRBO benchmark needs.
    """

    def __init__(self, dim: int = 3, goal: Optional[Sequence[float]] = None):
        assert dim in (3, 4)
        self.dim = dim
        self.goal = np.asarray(goal if goal is not None else (3.0, 4.0), float)

    @property
    def space(self) -> DesignSpace:
        spec = [
            {"name": "rx", "type": "num", "lb": -5.0, "ub": 5.0},
            {"name": "ry", "type": "num", "lb": -5.0, "ub": 5.0},
            {"name": "t", "type": "num", "lb": 1.0, "ub": 30.0},
        ]
        if self.dim == 4:
            spec.append(
                {"name": "phi", "type": "num", "lb": -np.pi / 4, "ub": np.pi / 4}
            )
        return DesignSpace(spec)

    def simulate(self, X: np.ndarray) -> np.ndarray:
        """(N, dim) rows → (N, 2) final puck positions."""
        X = np.atleast_2d(np.asarray(X, float))
        rx, ry, t = X[:, 0], X[:, 1], X[:, 2]
        phi = X[:, 3] if self.dim == 4 else np.zeros_like(rx)
        hand = np.stack([rx, ry], axis=1)
        d0 = np.linalg.norm(hand, axis=1)  # distance hand → puck center
        # unit push direction: hand→origin, rotated by phi
        base_dir = -hand / np.maximum(d0, 1e-9)[:, None]
        c, s = np.cos(phi), np.sin(phi)
        push_dir = np.stack(
            [c * base_dir[:, 0] - s * base_dir[:, 1],
             s * base_dir[:, 0] + c * base_dir[:, 1]],
            axis=1,
        )
        v_hand = 1.0  # hand speed (units/s)
        # time spent in contact after covering the approach distance
        # (puck radius 1 → contact at distance d0 - 1)
        t_contact = np.maximum(t - np.maximum(d0 - 1.0, 0.0) / v_hand, 0.0)
        # momentum transfer: puck leaves contact at hand speed, then
        # friction decelerates it — travel = v·τ − ½μτ², capped at v²/2μ
        mu = 0.05
        tau = np.minimum(t_contact, v_hand / mu)
        dist = v_hand * tau - 0.5 * mu * tau**2
        # pushing off-axis bleeds momentum (glancing contact)
        dist = dist * np.cos(phi) ** 2
        contact_pt = -push_dir  # rim point where the hand strikes
        return contact_pt + push_dir * (1.0 + dist[:, None])

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        cols = ["rx", "ry", "t"] + (["phi"] if self.dim == 4 else [])
        final = self.simulate(df[cols].values)
        return np.linalg.norm(final - self.goal[None, :], axis=1).reshape(-1, 1)


# ------------------------------------------------------- execution noise
class UncertainEvalWrapper:
    """Evaluates ``task`` at x + ε, ε ~ N(0, σ²) — the input-execution
    noise protocol for robust BO.  Noise draws use common random numbers
    keyed on the call counter so repeated optimizer runs with the same
    seed see identical corruption sequences."""

    def __init__(self, task, input_std: float = 0.1, seed: int = 0):
        self.task = task
        self.input_std = input_std
        self.seed = seed
        self._calls = 0

    @property
    def space(self) -> DesignSpace:
        return self.task.space

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        sp = self.space
        X = sp.transform(df).astype(float)
        rng = np.random.default_rng((self.seed, self._calls))
        self._calls += 1
        lb, ub = sp.opt_lb, sp.opt_ub
        span = np.maximum(ub - lb, 1e-12)
        Xn = X + rng.normal(0.0, self.input_std, X.shape) * span
        Xn = np.clip(Xn, lb, ub)
        return self.task(sp.inverse_transform(Xn))
