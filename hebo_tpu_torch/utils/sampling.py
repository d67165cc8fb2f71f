"""Sampling utilities: DepRound dependent rounding (copy of ``hebo_tpu/utils/sampling.py``).

Parity: MCBO ``DepRound`` (mcbo/utils/dependant_rounding.py:1-137), used
by the CoCaBO mixed-MAB acquisition optimizer to draw a SUBSET of k arms
whose inclusion probabilities exactly match a given marginal vector p
(Σp = k).  The classic pipage-style pairwise rounding: repeatedly pick two
fractional coordinates and shift mass between them until all are 0/1.
"""

from __future__ import annotations

import numpy as np

__all__ = ["dep_round"]


def dep_round(p: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Binary vector x with E[x] = p exactly and Σx = Σp (integer)."""
    p = np.asarray(p, float).copy()
    k = p.sum()
    assert abs(k - round(k)) < 1e-9, "marginals must sum to an integer"
    eps = 1e-12
    while True:
        frac = np.where((p > eps) & (p < 1 - eps))[0]
        if len(frac) == 0:
            break
        if len(frac) == 1:
            p[frac[0]] = round(p[frac[0]])
            break
        i, j = frac[0], frac[1]
        # max mass shifts keeping both in [0, 1]
        alpha = min(1 - p[i], p[j])  # shift j→i
        beta = min(p[i], 1 - p[j])  # shift i→j
        if rng.random() < beta / (alpha + beta):
            p[i] += alpha
            p[j] -= alpha
        else:
            p[i] -= beta
            p[j] += beta
    return (p > 0.5).astype(int)
