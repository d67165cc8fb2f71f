"""The plain version of kernel K5 (nondominated rank, crowding, the NSGA-II
key and the survivor order: ``nsga2_select``) against hebo_tpu/ops/pareto.py
on the CPU, at exact equality.

NSGA-II ranks P = 100 points for the tournament and 2P = 200 for survival,
over MACE's M = 3 objectives; GeneralBO has M = 2 (ZDT1) and M = 4 (BNH:
2 objectives + 2 constraints), and BO, Evolution, MCBO's GA and the latent
loops a single objective at P 32-200.  Survival at pop 630-700 ranks
1,260-1,400 rows, which the card takes on K5's grid route.  The inputs hold ties (a few levels
per objective), duplicate rows, ±inf and NaN objectives (−log EI can be
inf), chains of P fronts and, for the rank, invalid rows.  The rank must be
equal, the crowding equal bit for bit (NaN where NaN), and so the NSGA-II
key and the first n_keep of its argsort.  At M = 1 the kernel ranks in
closed form (no peel); ``_rank_one_objective`` states that form here and is
held against the peel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hebo_tpu.ops import pareto as jpar
from hebo_tpu_torch.ops import pareto as tpar


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objectives(P, M, levels, edge, seed):
    """Objectives on ``levels`` levels (ties), or with ``levels`` None a
    chain: row i is (r_i, ..., r_i) for a permutation r, P fronts."""
    rng = np.random.default_rng(seed)
    if levels is None:
        F = np.repeat(rng.permutation(P).astype(np.float32)[:, None], M, 1)
    else:
        F = (rng.integers(0, levels, (P, M)) / levels).astype(np.float32)
        F[3] = F[4]  # exact duplicate rows
        F[10] = F[11] = F[12]
    if edge:
        F[20, 1 % M] = np.inf
        F[21, 1 % M] = np.inf  # two inf in one column: inf - inf in a front's span
        F[22, 0] = -np.inf
        F[23] = -np.inf
        F[30, 2 % M] = np.nan
        F[31] = np.nan
        F[40 % P, :] = ([np.inf, -np.inf, 0.5] * 2)[:M]
    return F


def _jax(F, valid=None):
    Fj = jnp.asarray(F)
    vj = None if valid is None else jnp.asarray(valid)
    r = jpar.nondominated_rank(Fj, vj)
    c = jpar.crowding_distance(Fj, r)
    return np.asarray(r), np.asarray(c), np.asarray(jpar.nsga2_key(r, c))


def _rank_one_objective(f, valid):
    """K5's rank at M = 1: a valid number's is the count of distinct valid
    numbers below it, a valid NaN's 0, an invalid row's 1 + the largest
    valid rank (0 when no row is valid)."""
    valid = np.ones(len(f), bool) if valid is None else valid
    nums = np.unique(f[valid & ~np.isnan(f)])  # -0 and +0 are one value
    r = np.where(np.isnan(f), 0, np.searchsorted(nums, f)).astype(np.int32)
    return np.where(valid, r, max(len(nums), 1) if valid.any() else 0).astype(np.int32)


def _assert_select_equals_jax(F, valid, n_keep):
    """``nsga2_select``'s plain version against the JAX package's rank,
    crowding, ``nsga2_key`` and ``argsort(key)[:n_keep]``."""
    rj, cj, kj = _jax(F, valid)
    vt = None if valid is None else torch.as_tensor(valid)
    rt, ct, kt, ot = tpar.nsga2_select(torch.as_tensor(F), n_keep, vt)
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_array_equal(ct.numpy().view(np.int32)[~np.isnan(cj)],
                                  cj.view(np.int32)[~np.isnan(cj)])
    np.testing.assert_array_equal(np.isnan(ct.numpy()), np.isnan(cj))
    np.testing.assert_array_equal(kt.numpy(), kj)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(jnp.argsort(jnp.asarray(kj))[:n_keep]))
    if F.shape[1] == 1:
        np.testing.assert_array_equal(_rank_one_objective(F[:, 0], valid), rj)
    return rj, cj, kj


def _cases(kinds):
    """(P, M, levels, edge) for M 1-4 and P 32, 100, 200; the cases that
    were there before M and P 32 were added keep their ids."""
    out = []
    for M in (1, 2, 3, 4):
        for P in (32, 100, 200):
            for levels, edge in kinds:
                old = M == 3 and P in (100, 200) and levels is not None
                ident = f"{levels}-{edge}-{P}" if old else f"M{M}-{levels or 'chain'}-{edge}-{P}"
                out.append(pytest.param(P, M, levels, edge, id=ident))
    return out


_KINDS = [(3, False), (1000, False), (4, True), (1000, True)]


# survival at pop 700 (MACE) and 650 (ZDT1), past the one-CTA route of
# kernel K5 on the card, on 8 tied levels with the edge values
_LARGE = [pytest.param(1400, 3, 8, True, id="M3-8-True-1400"),
          pytest.param(1300, 2, 8, True, id="M2-8-True-1300")]


@pytest.mark.parametrize("P,M,levels,edge",
                         _cases(_KINDS) + [pytest.param(P, 2, None, e, id=f"M2-chain-{e}-{P}")
                                           for P in (32, 200) for e in (False, True)] + _LARGE)
def test_rank_and_crowding_equal_hebo_tpu(P, M, levels, edge):
    F = _objectives(P, M, levels, edge, seed=P + (levels or 0))
    rj, cj, kj = _assert_select_equals_jax(F, None, P // 2)
    rt, ct = tpar.nsga2_rank_crowd(torch.as_tensor(F))
    np.testing.assert_array_equal(rt.numpy(), rj)
    np.testing.assert_array_equal(tpar.nsga2_key(rt, ct).numpy(), kj)
    # the split API gives the same
    np.testing.assert_array_equal(tpar.nondominated_rank(torch.as_tensor(F)).numpy(), rj)
    if levels is None and not edge:
        assert rj.max() == P - 1  # a chain: every point its own front
    if edge and M >= 2:
        assert np.isnan(cj).any() and np.isinf(cj).any()


@pytest.mark.parametrize("P,M", [pytest.param(P, M, id=str(P) if M == 3 else f"M{M}-{P}")
                                 for M in (1, 2, 3, 4) for P in (32, 100, 200, 1260)
                                 if P < 1260 or M == 3])
def test_rank_with_invalid_rows_equals_hebo_tpu(P, M):
    F = _objectives(P, M, 5, True, seed=P)
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
    _assert_select_equals_jax(F, valid, P // 2)
    # no valid row: every row is on front 0
    _assert_select_equals_jax(F, np.zeros(P, bool), P)
