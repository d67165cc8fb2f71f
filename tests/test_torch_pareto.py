"""The plain version of kernel K5 (nondominated rank + crowding) against
hebo_tpu/ops/pareto.py on the CPU, at exact equality.

NSGA-II ranks P = 100 points for the tournament and 2P = 200 for survival,
over MACE's M = 3 objectives.  The inputs hold ties (a few levels per
objective), duplicate rows, ±inf and NaN objectives (−log EI can be inf)
and, for the rank, invalid rows.  The rank must be equal, the crowding
equal bit for bit (NaN where NaN), and so the NSGA-II key.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hebo_tpu.ops import pareto as jpar
from hebo_tpu_torch.ops import pareto as tpar


def _objectives(P, M, levels, edge, seed):
    rng = np.random.default_rng(seed)
    F = (rng.integers(0, levels, (P, M)) / levels).astype(np.float32)
    F[3] = F[4]  # exact duplicate rows
    F[10] = F[11] = F[12]
    if edge:
        F[20, 1] = np.inf
        F[21, 1] = np.inf  # two inf in one column: inf - inf in a front's span
        F[22, 0] = -np.inf
        F[23] = -np.inf
        F[30, 2] = np.nan
        F[31] = np.nan
        F[40, :] = [np.inf, -np.inf, 0.5]
    return F


def _jax(F, valid=None):
    Fj = jnp.asarray(F)
    vj = None if valid is None else jnp.asarray(valid)
    r = jpar.nondominated_rank(Fj, vj)
    c = jpar.crowding_distance(Fj, r)
    return np.asarray(r), np.asarray(c), np.asarray(jpar.nsga2_key(r, c))


@pytest.mark.parametrize("P", [100, 200])
@pytest.mark.parametrize("levels,edge", [(3, False), (1000, False), (4, True), (1000, True)])
def test_rank_and_crowding_equal_hebo_tpu(P, levels, edge):
    F = _objectives(P, 3, levels, edge, seed=P + levels)
    rj, cj, kj = _jax(F)
    rt, ct = tpar.nsga2_rank_crowd(torch.as_tensor(F))
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_array_equal(ct.numpy().view(np.int32)[~np.isnan(cj)],
                                  cj.view(np.int32)[~np.isnan(cj)])
    np.testing.assert_array_equal(np.isnan(ct.numpy()), np.isnan(cj))
    np.testing.assert_array_equal(tpar.nsga2_key(rt, ct).numpy(), kj)
    # the split API gives the same
    np.testing.assert_array_equal(tpar.nondominated_rank(torch.as_tensor(F)).numpy(), rj)
    if edge:
        assert np.isnan(cj).any() and np.isinf(cj).any()


@pytest.mark.parametrize("P", [100, 200])
def test_rank_with_invalid_rows_equals_hebo_tpu(P):
    F = _objectives(P, 3, 5, True, seed=P)
    valid = np.random.default_rng(P).uniform(size=P) > 0.25
    valid[3] = False  # one of a duplicate pair
    rj, cj, _ = _jax(F, valid)
    rt = tpar.nondominated_rank(torch.as_tensor(F), torch.as_tensor(valid))
    np.testing.assert_array_equal(rt.numpy(), rj)
    assert rj[~valid].min() > rj[valid].max()  # invalid rows sink below every valid one
    rt2, ct2 = tpar.nsga2_rank_crowd(torch.as_tensor(F), torch.as_tensor(valid))
    np.testing.assert_array_equal(rt2.numpy(), rj)
    np.testing.assert_array_equal(np.isnan(ct2.numpy()), np.isnan(cj))
    np.testing.assert_array_equal(ct2.numpy()[~np.isnan(cj)], cj[~np.isnan(cj)])
