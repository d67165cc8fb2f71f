"""RDUCB in hebo_tpu_torch (the random-decomposition GP, the structure
learner, AddLCB, the message-passing optimizer, ``relearn_every``) and the
acquisition API (``eval_pure``, ``__call__``, ``LCB(kappa=)``) against
hebo_tpu on CPU.

Tolerances (float32 on both sides):
* ``random_tree`` and the clique samplers: identical;
* the Gram, ``prior_diag``, the cache's L and the per-clique posteriors on
  carried-across parameters: rtol 1e-5 (atol 1e-5 × the largest |value|,
  where a cancellation can leave an entry near 0); the cache's α 1e-4 (a
  solve: float32 rounding times the condition number);
* the loss gradient: rtol / atol 1e-3 (as tests/test_torch_gp.py);
* every move's candidate log-likelihoods: 1e-4; the Gibbs learner with the
  JAX package's permutation and Gumbels fed in: the same assignment and its
  log-likelihood within 1e-4;
* AddLCB against the summed per-clique LCBs and the JAX package's: 1e-5;
* the message-passing optimizer on a carried-across model: the same points
  (1e-6: grid values);
* a user acquisition through HEBO's generic route on a carried-across GP
  with the JAX package's NSGA-II draws fed in: the same suggestion (1e-5).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.acq_optimizers.message_passing import MessagePassingOptimizer as JMP
from hebo_tpu.acquisitions import acq as jacq
from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.models import get_model as jget_model
from hebo_tpu.models.gp import rd_gp as jrd
from hebo_tpu.models.gp import structure as jst
from hebo_tpu.models.gp.gp import _make_data
from hebo_tpu.optimizers.hebo import HEBO as JHEBO
from hebo_tpu_torch import HEBO
from hebo_tpu_torch.acq_optimizers.message_passing import MessagePassingOptimizer
from hebo_tpu_torch.acquisitions import acq as tacq
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.models import get_model
from hebo_tpu_torch.models.gp import data_from_jax, model_from_jax, params_from_jax
from hebo_tpu_torch.models.gp import rd_gp as trd
from hebo_tpu_torch.models.gp import structure as tst
from hebo_tpu_torch.optimizers.bo_builder import BO_ALGOS

MIXED = [{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(3)] + [
    {"name": "c", "type": "cat", "categories": ["a", "b", "c"]}]
CONT = [{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(4)]
T = torch.as_tensor


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX package's compiles at XLA's lowest backend optimization level
    (as tests/test_torch_mcbo.py; restored before conftest's teardown)."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _np(t):
    return {k: np.asarray(v) for k, v in t._asdict().items() if v is not None}


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30))


def _xy(space, n=20, seed=0):
    X = space.sobol_sample_opt(n, seed=seed).astype(np.float32)
    y = (X[:, :1] ** 2 - X[:, 1:2] + 0.5 * X[:, 2:3] * X[:, -1:]).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    """JAX RDGPs fitted once per decomposition and carried into the port:
    {name: (jax model, port model, X, y)}."""
    out = {}
    for name, specs, conf in (("tree", MIXED, {}), ("nonoverlap", CONT, {"decomposition": "nonoverlap"}),
                              ("learn", CONT, {"decomposition": "learn"})):
        js, ts = JSpace(specs), DesignSpace(specs)
        X, y = _xy(ts)
        jm = jget_model("gp_rd", js, num_epochs=10, **conf)
        jm.fit(X, y)
        tm = model_from_jax(jm, get_model("gp_rd", ts, device="cpu", num_epochs=10, **conf))
        out[name] = (jm, tm, X, y)
    return out


# ------------------------------------------------------------ host samplers
def test_random_tree_and_clique_samplers_are_identical():
    for D in (1, 2, 7, 60):
        for seed in range(3):
            rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
            assert trd.random_tree(D, rng_t) == jrd.random_tree(D, rng_j)
            assert trd.graph_overlap_cliques(D, rng_t, 3) == jrd.graph_overlap_cliques(D, rng_j, 3)
            assert trd.graph_nonoverlap_cliques(D, rng_t, 3) == jrd.graph_nonoverlap_cliques(D, rng_j, 3)


def test_resample_decomposition_follows_the_seed_sequence():
    js, ts = JSpace(CONT), DesignSpace(CONT)
    for conf in ({}, {"decomposition": "overlap"}, {"decomposition": "nonoverlap"}):
        jm = jget_model("gp_rd", js, **conf)
        tm = get_model("gp_rd", ts, device="cpu", **conf)
        for _ in range(3):
            assert tm.cliques == jm.cliques and tm.core.cliques == jm.core.cliques
            jm.resample_decomposition()
            tm.resample_decomposition()
        assert tm._decomp_seed == jm._decomp_seed == 4
    with pytest.raises(ValueError, match="unknown decomposition"):
        get_model("gp_rd", ts, device="cpu", decomposition="star")


# -------------------------------------------------------------------- core
def test_gram_prior_cache_and_predict_on_carried_params(fitted):
    jm, tm, X, y = fitted["tree"]
    jcore, tcore = jm.core, tm.core
    p0 = jax.tree.map(lambda t: t[0], jm.samples)
    Xq = DesignSpace(MIXED).sobol_sample_opt(9, seed=4).astype(np.float32)
    Kj = jcore.gram_points(p0, jm.data.X, jnp.asarray(Xq), jm.data)
    Kt = tcore.gram_points(tm.samples, tm.data.X, T(Xq), tm.data)[0]
    _close(Kt.numpy(), Kj, 1e-5)
    _close(tcore.prior_diag(tm.samples).numpy(), [float(jcore.prior_diag(p0))], 1e-5)
    cache = tcore.posterior_cache_batched(tm.samples, tm.data)
    assert bool(cache.ok.all())
    _close(cache.L.numpy(), np.asarray(jm.caches.L), 1e-5)
    # α = Kt⁻¹ r carries the float32 rounding of the two factorizations
    # times Kt's condition number: 1e-4 of its largest entry, as the GP's
    # caches in tests/test_torch_gp.py
    _close(cache.alpha.numpy(), np.asarray(jm.caches.alpha), 1e-4)
    mu, var = tm.predict(Xq)
    mj, vj = jm.predict(Xq)
    _close(mu, mj, 1e-5)
    _close(var, vj, 1e-5)
    for c in range(len(jm.cliques)):
        mc, vc = tm.predict_clique(Xq, c)
        mcj, vcj = jm.predict_clique(Xq, c)
        _close(mc, mcj, 1e-5)
        _close(vc, vcj, 1e-5)
    # every clique at its own query set in one call
    sets = [Xq[c : c + 5] for c in range(len(jm.cliques))]
    mus, vars_ = tm.predict_cliques(sets, list(range(len(sets))))
    for c, (m_, v_) in enumerate(zip(mus, vars_)):
        mcj, vcj = jm.predict_clique(sets[c], c)
        _close(m_, mcj, 1e-5)
        _close(v_, vcj, 1e-5)


def test_loss_value_and_gradient(fitted):
    jm, tm, _, _ = fitted["tree"]
    p0 = jax.tree.map(lambda t: t[:1] * 0.9, jm.samples)
    lj, gj = jax.jit(jax.value_and_grad(lambda P: jnp.sum(jm.core.loss_batched(P, jm.data))))(p0)
    leaves = params_from_jax(_np(p0), device="cpu")
    leaves = type(leaves)(*[None if t is None else t.requires_grad_(True) for t in leaves])
    loss = tm.core.loss_batched(leaves, tm.data)
    np.testing.assert_allclose(loss.detach().numpy(), [float(lj)], rtol=1e-4)
    grads = torch.autograd.grad(loss.sum(), [leaves.log_ls, leaves.log_noise, leaves.mean])
    for g, want in zip(grads, (gj.log_ls, gj.log_noise, gj.mean)):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)


def test_init_params_with_fed_draws():
    js, ts = JSpace(MIXED), DesignSpace(MIXED)
    X, y = _xy(ts)
    jm = jget_model("gp_rd", js)
    tm = get_model("gp_rd", ts, device="cpu")
    jd = _make_data(X, y, jm.core.numeric_dims, 32)
    key = jax.random.PRNGKey(5)
    pj = jm.core.init_params(key, jd)
    z_ls = jax.random.normal(jax.random.split(key)[1], (jm.core.d_feat,), jnp.float32)
    pt = tm.core.init_params(data_from_jax(_np(jd), device="cpu"), 1, draws=(None, np.asarray(z_ls)[None]))
    for f in ("log_ls", "log_sc", "log_noise", "mean", "log_wa", "log_wb"):
        np.testing.assert_allclose(getattr(pt, f)[0].numpy(), np.asarray(getattr(pj, f)), rtol=1e-6)
    assert pt.emb.shape == (1, 0, 0)


# ----------------------------------------------------------- structure
def _additive(n=40, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    y = (np.sin(4 * X[:, 0] * X[:, 1]) + (X[:, 2] - X[:, 3]) ** 2).reshape(-1, 1)
    return X, y.astype(np.float32)


def test_dim_log_kernels_and_every_move():
    X, y = _additive()
    X = np.concatenate([X, np.random.default_rng(1).integers(0, 3, (len(X), 1))], 1).astype(np.float32)
    jd = _make_data(X, y, (0, 1, 2, 3), 64)
    td = data_from_jax(_np(jd), device="cpu")
    nd, cd, M = (0, 1, 2, 3), (4,), 4
    Ldj = jax.jit(jst.dim_log_kernels, static_argnums=(3, 4))(jd.X, jd.x_lb, jd.x_span, nd, cd)
    jmll = jax.jit(jst.assignment_mll, static_argnums=4)
    Ldt = tst.dim_log_kernels(td.X, td.x_lb, td.x_span, nd, cd)
    np.testing.assert_allclose(Ldt.numpy(), np.asarray(Ldj), rtol=1e-5, atol=1e-5)
    z = np.asarray([0, 1, 1, 2, 0])
    for j in range(5):
        got = tst.move_mlls(T(z), j, Ldt, td.y, td.mask, M)
        want = [float(jmll(jnp.asarray(z).at[j].set(m), Ldj, jd.y, jd.mask, M)) for m in range(M)]
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    np.testing.assert_allclose(float(tst.assignment_mll(T(z), Ldt, td.y, td.mask, M)),
                               float(jmll(jnp.asarray(z), Ldj, jd.y, jd.mask, M)), rtol=1e-4)


def _jax_gibbs_draws(key, D, M, n_sweeps):
    """structure.py:141-154's key schedule: the permutation, then one split
    per move for its Gumbels."""
    k_init, k = jax.random.split(key)
    perm = np.asarray(jax.random.permutation(k_init, D))
    g = []
    for _ in range(n_sweeps * D):
        k, kg = jax.random.split(k)
        g.append(np.asarray(jax.random.gumbel(kg, (M,))))
    return perm, np.stack(g)


@pytest.mark.parametrize("mgs,M,seed", [(2, 4, 0), (1, 4, 3), (3, 3, 1)])
def test_learn_assignment_with_fed_draws(mgs, M, seed):
    X, y = _additive(seed=seed)
    jd = _make_data(X, y, (0, 1, 2, 3), 64)
    td = data_from_jax(_np(jd), device="cpu")
    kw = dict(numeric_dims=(0, 1, 2, 3), cat_dims=(), M=M, max_group_size=mgs, n_sweeps=2)
    key = jax.random.PRNGKey(seed)
    zj, mj = jst.learn_assignment(key, jd.X, jd.y, jd.mask, jd.x_lb, jd.x_span, **kw)
    draws = _jax_gibbs_draws(key, 4, M, 2)
    zt, mt = tst.learn_assignment(td.X, td.y, td.mask, td.x_lb, td.x_span, draws=draws, **kw)
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_allclose(float(mt), float(mj), rtol=1e-4)
    assert np.bincount(zt.numpy(), minlength=M).max() <= mgs
    assert tst.assignment_to_cliques(zt.numpy(), M) == jst.assignment_to_cliques(np.asarray(zj), M)


# -------------------------------------------------------------- acquisition
def test_addlcb_matches_summed_cliques_and_the_jax_package(fitted):
    jm, tm, _, _ = fitted["tree"]
    Xq = DesignSpace(MIXED).sobol_sample_opt(8, seed=6).astype(np.float32)
    got = tacq.AddLCB().eval_pure(tm, tm.state, tacq.AcqParams(kappa=1.96), T(Xq)).numpy()
    want = np.zeros((8, 1))
    for c in range(len(tm.core.cliques)):
        mu_c, var_c = tm.predict_clique(Xq, c)
        want += mu_c - 1.96 * np.sqrt(var_c)
    _close(got, want, 1e-5)
    jgot = jacq.AddLCB().eval_pure(jm, jm.state, jacq.AcqParams(kappa=jnp.float32(1.96)), jnp.asarray(Xq))
    _close(got, jgot, 1e-5)
    np.testing.assert_array_equal(tacq.AddLCB()(tm, Xq, tacq.AcqParams(kappa=1.96)), got)


@pytest.mark.parametrize("name", ["tree", "nonoverlap", "learn"])
def test_message_passing_picks_the_jax_packages_points(fitted, name):
    jm, tm, _, _ = fitted[name]
    js, ts = jm.space, tm.space
    want = JMP(js, grid_size=6).optimize(jm, jacq.LCB(), jacq.AcqParams(kappa=jnp.float32(2.0)),
                                         n_suggestions=2, seed=3)
    got = MessagePassingOptimizer(ts, grid_size=6).optimize(tm, tacq.LCB(), tacq.AcqParams(kappa=2.0),
                                                           n_suggestions=2, seed=3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.array_equal(got, ts.round_opt(got))


def test_message_passing_refuses_overlapping_cliques(fitted):
    _, tm, _, _ = fitted["nonoverlap"]
    saved = tm.cliques
    mp = MessagePassingOptimizer(tm.space, grid_size=4)
    try:
        tm.cliques = [(0, 1, 2), (2, 3, 0)]
        with pytest.raises(ValueError, match="disjoint partition"):
            mp._solve(tm, 2.0, mp._grids(tm.space.opt_lb, tm.space.opt_ub), tm.space.opt_lb.copy())
    finally:
        tm.cliques = saved
    with pytest.raises(ValueError, match="decomposition model"):
        mp.optimize(get_model("gp", tm.space, device="cpu"), tacq.LCB(), tacq.AcqParams())


# ------------------------------------------------------------------ RDUCB
def _obj(df):
    X = df[[f"x{i}" for i in range(3)]].values.astype(float)
    return ((X ** 2).sum(1) - (df["c"].values == "b")).reshape(-1, 1)


@pytest.mark.parametrize("conf", [{}, {"decomposition": "learn", "n_structure_sweeps": 1}])
def test_rducb_relearn_every_resamples_the_decomposition(conf):
    space = DesignSpace(MIXED)
    b = dataclasses.replace(BO_ALGOS["RDUCB"], model_kwargs={"num_epochs": 5, **conf},
                            acq_opt_kwargs={"grid_size": 6})
    opt = b.build_bo(space, n_init=2, device="cpu", relearn_every=2)
    seeds = []
    for _ in range(5):
        rec = opt.suggest(2)
        X = space.transform(rec)
        assert len(rec) == 2 and np.isfinite(X).all() and np.array_equal(X, space.round_opt(X))
        opt.observe(rec, _obj(rec))
        seeds.append(opt.model._decomp_seed)
    # the construction's draw, then one at every second model suggest (the
    # first suggest is the Sobol init); with "learn" the fit after each
    # resample runs the learner (from 3 observations on), which draws the
    # next seed
    assert seeds == ([1, 1, 3, 3, 5] if conf else [1, 1, 2, 2, 3])
    assert opt.num_obs == 10 and np.isfinite(opt.best_y)


# ------------------------------------------------------ acquisition API
class _JUserLCB(jacq.Acquisition):
    def eval_pure(self, model, state, params, X):
        mu, var = model.predict_pure(state, X)
        return mu - 1.5 * jnp.sqrt(jnp.maximum(var, 1e-12))


class _TUserLCB(tacq.Acquisition):
    def eval_pure(self, model, state, params, X):
        mu, var = model.predict_pure(state, X)
        return mu - 1.5 * torch.sqrt(torch.clamp(var, min=1e-12))


def test_user_acquisition_with_eval_pure_gives_the_jax_packages_suggestion(monkeypatch):
    """HEBO(acq_cls=…) on the generic route (``gpy_mlp``): the JAX package
    fits its GP in its suggest; the port takes that GP across and the JAX
    package's NSGA-II draws, and must suggest the same batch."""
    from hebo_tpu_torch.optimizers import hebo as thebo
    from test_torch_acq_evo import _jax_draws

    js, ts = JSpace(CONT), DesignSpace(CONT)
    kw = dict(model_name="gpy_mlp", pop=16, iters=3, model_config={"num_epochs": 8})
    jopt = JHEBO(js, acq_cls=_JUserLCB, **kw)
    topt = HEBO(ts, acq_cls=_TUserLCB, device="cpu", **kw)
    warm = ts.sample(12, seed=2)
    y = (warm.values.astype(float) ** 2).sum(1, keepdims=True)
    jopt.observe(warm, y)
    topt.observe(warm, y)
    want = jopt.suggest(4)

    tm = model_from_jax(jopt.model, get_model("gpy_mlp", ts, device="cpu", num_epochs=8))
    monkeypatch.setattr(tm, "fit", lambda X, y: tm)
    topt.model = tm
    draws = _jax_draws(jax.random.PRNGKey(topt.num_obs), 3, 16, ts.num_cols)

    class _Fed(thebo.EvolutionOpt):
        def optimize(self, *a, **k):
            return super().optimize(*a, draws=lambda g: draws[g], **k)

    monkeypatch.setattr(thebo, "EvolutionOpt", _Fed)
    got = topt.suggest(4)
    np.testing.assert_allclose(got.values.astype(float), want.values.astype(float), rtol=1e-5, atol=1e-5)


def test_acquisition_call_and_lcb_kappa(fitted):
    _, tm, _, _ = fitted["tree"]
    assert tacq.LCB(kappa=3.0).kappa == 3.0 and tacq.LCB().kappa == 2.0
    Xq = DesignSpace(MIXED).sobol_sample_opt(5, seed=1).astype(np.float32)
    pr = tacq.AcqParams(kappa=1.2)
    out = tacq.LCB(kappa=3.0)(tm, Xq, pr)
    assert isinstance(out, np.ndarray) and out.shape == (5, 1)
    np.testing.assert_array_equal(out, tacq.LCB().eval_pure(tm, tm.state, pr, T(Xq)).detach().numpy())
    assert not hasattr(tacq.Acquisition, "eval")
    with pytest.raises(NotImplementedError):
        tacq.Acquisition().eval_pure(tm, tm.state, pr, T(Xq))
    from hebo_tpu_torch.models.base import BaseModel
    with pytest.raises(NotImplementedError):
        BaseModel(DesignSpace(CONT)).sample_f()
