"""hebo_tpu_torch's MACE, Pareto ops and NSGA-II against hebo_tpu on CPU.

The JAX side's random draws (MACE jitter, one NSGA-II generation's
tournament and operator uniforms) are replayed from its key schedule and fed
to the port.  Tolerances: acquisition values rtol 1e-5 / atol 1e-5
(float32 special functions differ in the last bits); ranks, crowding and
sort keys exactly; one NSGA-II generation 1e-5 (float32 powers).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.acq_optimizers.evolution import _space_meta as jmeta
from hebo_tpu.acq_optimizers.evolution import evolve_raw as jevolve
from hebo_tpu.acquisitions import acq as jacq
from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.ops import pareto as jpar
from hebo_tpu_torch.acq_optimizers.evolution import GenDraws, _space_meta, evolve_raw
from hebo_tpu_torch.acquisitions import acq as tacq
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.ops import pareto as tpar


class _Fixed:
    """A model whose predictive (mu, var) is fixed."""

    def __init__(self, mu, var):
        self.mu, self.var = mu, var

    def predict_pure(self, state, X):
        return self.mu, self.var


def _mu_var(rng, P=64):
    mu = np.concatenate([rng.normal(0, 1, P - 8), [9.0, 12.0, 30.0, -3.0, 0.0, 0.5, 5.0, 8.0]])
    var = np.concatenate([rng.uniform(0.01, 2.0, P - 8), [0.04, 0.01, 0.5, 1.0, 1e-14, 0.2, 0.01, 4.0]])
    return mu.astype(np.float32)[:, None], var.astype(np.float32)[:, None]


@pytest.mark.parametrize("jitter", [False, True])
def test_mace_values(jitter):
    rng = np.random.default_rng(0)
    mu, var = _mu_var(rng)
    key = jax.random.PRNGKey(5) if jitter else None
    pj = jacq.AcqParams(tau=jnp.float32(0.2), kappa=jnp.float32(2.5), eps=jnp.float32(1e-4),
                        key=key, noise=jnp.float32(0.3))
    Fj = jacq.MACE().eval_pure(_Fixed(jnp.asarray(mu), jnp.asarray(var)), None, pj, jnp.zeros((64, 2)))
    z = torch.as_tensor(np.asarray(jax.random.normal(key, mu.shape, jnp.float32))) if jitter else None
    pt = tacq.AcqParams(tau=0.2, kappa=2.5, eps=1e-4, noise=0.3, z=z)
    Ft = tacq.MACE().eval_pure(_Fixed(torch.as_tensor(mu), torch.as_tensor(var)), None, pt, None)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-5, atol=1e-5)
    z_all = (0.2 - 1e-4 - mu) / np.sqrt(np.maximum(var, 1e-12))
    assert (z_all <= -6).sum() >= 3  # the asymptotic branch is exercised


def test_single_objective_acquisitions():
    rng = np.random.default_rng(1)
    mu, var = _mu_var(rng)
    mj, mt = _Fixed(jnp.asarray(mu), jnp.asarray(var)), _Fixed(torch.as_tensor(mu), torch.as_tensor(var))
    pj = jacq.AcqParams(tau=jnp.float32(0.1), kappa=jnp.float32(1.5))
    pt = tacq.AcqParams(tau=0.1, kappa=1.5)
    for jc, tc in ((jacq.LCB, tacq.LCB), (jacq.EI, tacq.EI), (jacq.PI, tacq.PI)):
        np.testing.assert_allclose(tc().eval_pure(mt, None, pt, None).numpy(),
                                   np.asarray(jc().eval_pure(mj, None, pj, None)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("P,M,levels", [(40, 3, 4), (100, 3, 1000), (30, 2, 3)])
def test_rank_crowding_key_with_ties(P, M, levels):
    rng = np.random.default_rng(P + levels)
    F = (rng.integers(0, levels, (P, M)) / levels).astype(np.float32)
    F[5] = F[6]  # exact duplicate points
    rj = jpar.nondominated_rank(jnp.asarray(F))
    cj = jpar.crowding_distance(jnp.asarray(F), rj)
    kj = jpar.nsga2_key(rj, cj)
    Ft = torch.as_tensor(F)
    rt = tpar.nondominated_rank(Ft)
    ct = tpar.crowding_distance(Ft, rt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(tpar.nsga2_key(rt, ct).numpy(), np.asarray(kj))
    valid = rng.uniform(size=P) > 0.2
    np.testing.assert_array_equal(
        tpar.nondominated_rank(Ft, torch.as_tensor(valid)).numpy(),
        np.asarray(jpar.nondominated_rank(jnp.asarray(F), jnp.asarray(valid))),
    )


SPACE = [
    {"name": "x0", "type": "num", "lb": -2.0, "ub": 3.0},
    {"name": "x1", "type": "pow", "lb": 1e-3, "ub": 1.0},
    {"name": "k", "type": "int", "lb": 0, "ub": 9},
    {"name": "c", "type": "cat", "categories": ["a", "b", "c", "d"]},
]


def _objectives(X, xp):
    return xp.stack([(X ** 2).sum(1), ((X - 1.0) ** 2).sum(1), xp.round(X[:, 2] / 3.0)], 1)


def _jax_draws(key, n_gens, P, D):
    """Replay evolution.py:158 and the operators' key splits."""
    out, k = [], key
    for _ in range(n_gens):
        k, k_sel, k_sbx, k_mut, k_cat = jax.random.split(k, 5)
        u = lambda kk: torch.as_tensor(np.asarray(jax.random.uniform(kk, (P, D))))
        s1, s2, s3 = jax.random.split(k_sbx, 3)
        m1, m2 = jax.random.split(k_mut)
        c1, c2, c3 = jax.random.split(k_cat, 3)
        sel = torch.as_tensor(np.asarray(jax.random.randint(k_sel, (2, P), 0, P)))
        out.append(GenDraws(sel, u(s1), u(s2), u(s3), u(m1), u(m2), u(c1), u(c2), u(c3)))
    return out


@pytest.mark.parametrize("fix", [None, {"k": 4}])
def test_nsga2_generations_with_fed_draws(fix):
    js, ts = JSpace(SPACE), DesignSpace(SPACE)
    P, D, n_gens = 24, ts.num_cols, 2
    init = ts.sobol_sample_opt(P, seed=1).astype(np.float32)
    if fix:
        init[:, 2] = 4.0
    key = jax.random.PRNGKey(3)
    Xj, Fj = jevolve(key, jnp.asarray(init), None,
                     eval_fn=lambda args, X: _objectives(X, jnp), meta=jmeta(js, fix), n_gens=n_gens)
    draws = _jax_draws(key, n_gens, P, D)
    Xt, Ft = evolve_raw(torch.as_tensor(init), lambda X: _objectives(X, torch),
                        _space_meta(ts, fix), n_gens=n_gens, draws=lambda g: draws[g])
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-5, atol=1e-5)
    assert ((Xt >= torch.as_tensor(ts.opt_lb, dtype=torch.float32))
            & (Xt <= torch.as_tensor(ts.opt_ub, dtype=torch.float32))).all()
    if fix:
        assert (Xt[:, 2] == 4.0).all()


class _Bowl:
    """A model whose posterior is a fixed function of X, in either package."""

    device = "cpu"
    state = None

    def __init__(self, xp, D):
        self.xp, self.w = xp, xp.ones((D, 1)) if xp is torch else jnp.ones((D, 1))

    def predict_pure(self, state, X):
        return ((X - 0.3) ** 2) @ self.w, 0.05 + 0.1 * X[:, :1] ** 2


@pytest.mark.parametrize("fix", [None, {"k": 4}])
def test_evolution_opt_with_fed_draws(fix):
    """``EvolutionOpt.optimize`` (Sobol X0 at ``seed``, the incumbent in
    row 0, the ``fix_input`` columns) with MACE on a fixed surrogate, the
    JAX package's draws fed through ``draws=``: the same population and
    objectives (1e-5), rounded by the space."""
    from hebo_tpu.acq_optimizers.evolution import EvolutionOpt as JEvo
    from hebo_tpu_torch.acq_optimizers import EvolutionOpt

    js, ts = JSpace(SPACE), DesignSpace(SPACE)
    P, D, iters, seed = 16, ts.num_cols, 3, 5
    inc = ts.sobol_sample_opt(1, seed=9)
    jx, jf = JEvo(js, jacq.MACE(), pop=P, iters=iters).optimize(
        model=_Bowl(jnp, D), acq_params=jacq.AcqParams(tau=jnp.float32(0.5), kappa=jnp.float32(2.0)),
        initial_suggest=inc, fix_input=fix, return_pop=True, seed=seed)
    draws = _jax_draws(jax.random.PRNGKey(seed), iters, P, D)
    evo = EvolutionOpt(ts, tacq.MACE(), pop=P, iters=iters)
    tx, tf = evo.optimize(model=_Bowl(torch, D), acq_params=tacq.AcqParams(tau=0.5, kappa=2.0),
                          initial_suggest=inc, fix_input=fix, return_pop=True, seed=seed,
                          draws=lambda g: draws[g])
    np.testing.assert_allclose(tx, jx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tf, jf, rtol=1e-5, atol=1e-5)
    assert np.array_equal(tx, ts.round_opt(tx))
    if fix:
        assert (tx[:, 2] == 4.0).all()
    # the best point alone, from the generator seeded at ``seed``
    best = evo.optimize(model=_Bowl(torch, D), initial_suggest=inc, seed=seed)
    assert best.shape == (1, D) and np.isfinite(best).all()
