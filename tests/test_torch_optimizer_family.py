"""The optimizer family in hebo_tpu_torch (BO, GeneralBO with EHVI,
NoisyOpt, NoMR_BO, contextual and embedding HEBO, CMA-ES, Evolution, the
baselines, MACEBO, the Bayesmark adapters and sklearn_tuner) against
hebo_tpu on CPU.

Tolerances (float32 on both sides, different summation orders):
* ``MultiTaskModel``'s predictions with the JAX members carried across:
  rtol / atol 1e-4 (as tests/test_torch_gp.py);
* ``pareto_mask`` exactly; ``hypervolume_mc`` with the JAX uniforms fed:
  1e-6;
* acquisition values: rtol / atol 1e-5;
* EHVI's greedy picks on a carried-across model with the JAX uniforms fed:
  the same indices;
* CMA-ES' sample with the JAX normals fed and three generation updates:
  rtol / atol 1e-5; Evolution's survival exactly, its mating with the JAX
  draws fed at 1e-5;
* host numpy (the projection matrices, the baselines, the Bayesmark spaces
  and losses): identical.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

import hebo_tpu.optimizers as J
from hebo_tpu.acquisitions import acq as jacq
from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.models import get_model as jget_model
from hebo_tpu.ops import pareto as jpareto
from hebo_tpu.optimizers import cmaes as jcmaes
from hebo_tpu.optimizers import evolution as jevolution
from hebo_tpu.tasks import bayesmark as jbm
import hebo_tpu_torch.optimizers as O
from hebo_tpu_torch import DesignSpace
from hebo_tpu_torch.acq_optimizers.evolution import GenDraws, meta_tensors
from hebo_tpu_torch.acquisitions import acq as tacq
from hebo_tpu_torch.models import get_model
from hebo_tpu_torch.models.gp import model_from_jax
from hebo_tpu_torch.ops import pareto as tpareto
from hebo_tpu_torch.optimizers import cmaes as tcmaes
from hebo_tpu_torch.optimizers import evolution as tevolution
from hebo_tpu_torch.optimizers.hebo import _leaf_shapes
from hebo_tpu_torch.tasks import bayesmark as tbm

T = torch.as_tensor
CONT = [{"name": "x0", "type": "num", "lb": -3, "ub": 3},
        {"name": "x1", "type": "num", "lb": -3, "ub": 3}]
SMALL = {"model_config": {"num_epochs": 10}, "pop": 16, "iters": 8}


@pytest.fixture(scope="module", autouse=True)
def _quick_jax_compiles():
    """The JAX package's compiles at XLA's lowest backend optimization
    level (the same operations, so the same values up to float32
    rounding); restored before conftest's module teardown clears the jit
    caches (see tests/test_torch_mcbo.py)."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _quad(df):
    x = df[["x0", "x1"]].values.astype(float)
    return np.sum(x ** 2, axis=1, keepdims=True)


def _bi(df):
    """Two objectives of one variable: x² and (x − 2)²."""
    x = df["x0"].values.astype(float)
    return np.stack([x ** 2, (x - 2.0) ** 2], axis=1)


# ---------------------------------------------------------------- exports
def test_exports_every_name_of_the_jax_package():
    names = [n for n, v in vars(J).items()
             if not n.startswith("_") and not isinstance(v, type(J))]
    missing = [n for n in names if not hasattr(O, n)]
    assert not missing, missing
    import hebo_tpu_torch

    for n in ("HEBO", "BO", "GeneralBO", "CMAES", "Evolution", "NoisyOpt", "get_model"):
        assert getattr(hebo_tpu_torch, n) is not None


# ------------------------------------------------------------ multi-task
@pytest.fixture(scope="module")
def multi():
    """A JAX ``multi_task`` model (two GPs) fitted on 14 Sobol points of a
    2-D space with two differently scaled outputs, and the port's model
    carrying it member by member."""
    js, ts = JSpace(CONT), DesignSpace(CONT)
    X = js.sobol_sample_opt(14, seed=3).astype(np.float32)
    Y = np.stack([(X ** 2).sum(1), 50.0 * np.sin(X[:, 0]) + X[:, 1]], 1)
    jm = jget_model("multi_task", js, num_out=2, num_epochs=8)
    jm.fit(X, Y)
    tm = model_from_jax(jm, get_model("multi_task", ts, num_out=2, device="cpu", num_epochs=8))
    return dict(js=js, ts=ts, X=X, Y=Y, jm=jm, tm=tm)


def test_multi_task_model_predicts_as_the_jax_one(multi):
    jm, tm = multi["jm"], multi["tm"]
    assert type(tm).__name__ == "MultiTaskModel" and len(tm.models) == 2
    Xq = multi["ts"].sobol_sample_opt(9, seed=11).astype(np.float32)
    for (a, b) in zip(tm.predict(Xq), jm.predict(Xq)):
        assert a.shape == (9, 2)
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-4)
    mu, var = tm.predict_pure(tm.state, T(Xq))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jm.predict(Xq)[0]), rtol=1e-4, atol=1e-4)
    assert isinstance(tm.state, tuple) and len(tm.state) == 2 and var.shape == (9, 2)
    np.testing.assert_allclose(tm.noise, np.asarray(jm.noise), rtol=1e-4)


def test_multi_task_members_fit_their_own_column():
    """Each member normalizes its own output: a constraint column 1e4 times
    the objective's scale leaves the objective's member unchanged."""
    ts = DesignSpace(CONT)
    X = ts.sobol_sample_opt(12, seed=2).astype(np.float32)
    y0 = (X ** 2).sum(1, keepdims=True)
    a = get_model("multi_task", ts, num_out=2, device="cpu", num_epochs=5)
    b = get_model("multi_task", ts, num_out=2, device="cpu", num_epochs=5)
    a.fit(X, np.hstack([y0, X[:, :1]]))
    b.fit(X, np.hstack([y0, 1e4 * X[:, :1] + 3.0]))
    np.testing.assert_array_equal(a.predict(X)[0][:, 0], b.predict(X)[0][:, 0])


# --------------------------------------------------------------- pareto
@pytest.mark.parametrize("levels", [None, 3])
def test_pareto_mask(levels):
    rng = np.random.default_rng(4)
    F = rng.standard_normal((40, 3)).astype(np.float32)
    if levels:
        F = np.round(F * levels) / levels  # ties and duplicate rows
    valid = rng.random(40) > 0.2
    for v in (None, valid):
        got = tpareto.pareto_mask(T(F), None if v is None else T(v)).numpy()
        want = np.asarray(jpareto.pareto_mask(jnp.asarray(F), None if v is None else jnp.asarray(v)))
        np.testing.assert_array_equal(got, want)


def test_hypervolume_mc_with_fed_uniforms():
    rng = np.random.default_rng(5)
    F = rng.uniform(0.0, 1.0, (6, 2)).astype(np.float32)
    ref = jnp.asarray([1.2, 1.3], jnp.float32)
    key = jax.random.PRNGKey(7)
    want = float(jpareto.hypervolume_mc(jnp.asarray(F), ref, key, n_samples=2048))
    u = T(np.array(jax.random.uniform(key, (2048, 2), jnp.float32)))
    got = tpareto.hypervolume_mc(T(F), T(np.array(ref)), u)
    assert abs(float(got) - want) <= 1e-6
    # a batch of point sets is the sets one by one, on the same uniforms
    sets = T(rng.uniform(0.0, 1.0, (4, 5, 2)).astype(np.float32))
    batched = tpareto.hypervolume_mc(sets, T(np.array(ref)), u)
    for i in range(4):
        assert float(batched[i]) == float(tpareto.hypervolume_mc(sets[i], T(np.array(ref)), u))


# --------------------------------------------------------- acquisitions
class _FakeMO:
    """Three outputs, fixed functions of X, in either package."""

    def predict_pure(self, state, X):
        xp = torch if isinstance(X, torch.Tensor) else jnp
        mu = xp.stack([X[:, 0], X[:, 1], X[:, 0] + X[:, 1]], 1)
        return mu, 0.1 + 0.05 * mu ** 2


def test_mo_mean_sigma_lcb_and_general_acq():
    X = np.random.default_rng(1).standard_normal((10, 2)).astype(np.float32)
    m = _FakeMO()
    pairs = [
        (jacq.MOMeanSigmaLCB(), tacq.MOMeanSigmaLCB(), _One(m), 3),
        (jacq.GeneralAcq(2, 1, c_kappa=0.5), tacq.GeneralAcq(2, 1, c_kappa=0.5), m, 3),
        (jacq.GeneralAcq(3), tacq.GeneralAcq(3), m, 3),
    ]
    for ja, ta, model, n_out in pairs:
        want = ja.eval_pure(model, None, jacq.AcqParams(tau=jnp.float32(0.3),
                                                        kappa=jnp.float32(1.5)), jnp.asarray(X))
        got = ta.eval_pure(model, None, tacq.AcqParams(tau=0.3, kappa=1.5), T(X))
        assert got.shape == (10, n_out) and ta.num_out == n_out
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


class _One:
    """The first output of a model."""

    def __init__(self, m):
        self.m = m

    def predict_pure(self, state, X):
        mu, var = self.m.predict_pure(state, X)
        return mu[:, :1], var[:, :1]


def test_noisy_acq_with_fed_eps():
    X = np.random.default_rng(2).standard_normal((12, 2)).astype(np.float32)
    m = _One(_FakeMO())
    key = jax.random.PRNGKey(9)
    want = J.NoisyAcq(3).eval_pure(m, None, jacq.AcqParams(key=key), jnp.asarray(X))
    eps = T(np.asarray(jax.random.normal(key, (1, 3), jnp.float32)))
    acq = O.NoisyAcq(3)
    assert acq.n_normals == 3
    got = acq.eval_pure(m, None, tacq.AcqParams(draw=eps), T(X))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # without a draw: one shared eps from a generator seeded 0
    a = acq.eval_pure(m, None, tacq.AcqParams(), T(X))
    assert torch.equal(a, acq.eval_pure(m, None, tacq.AcqParams(), T(X)))


def test_noisy_opt_draws_its_eps_with_the_suggest():
    """NoisyOpt's fused program takes its ε from the suggest's draws: one
    (1, num_samples) block after MACE's z, so the same observations give
    the same suggestion, and the population's objectives are μ + σε."""
    space = DesignSpace(CONT)
    opt = O.NoisyOpt(space, num_samples=4, device="cpu", **SMALL)
    warm = space.inverse_transform(space.sobol_sample_opt(8, seed=1))
    opt.observe(warm, _quad(warm))
    a = opt.suggest(3)
    R, core = opt.model.n_restarts, opt.model.core
    assert opt._draws(torch.device("cpu")).normal.numel() == (
        R * core.d_feat + core.n_steps * sum(int(np.prod(s)) for s in _leaf_shapes(core, R))
        + opt.pop + 4)
    opt2 = O.NoisyOpt(space, num_samples=4, device="cpu", **SMALL)
    opt2.observe(warm, _quad(warm))
    pd.testing.assert_frame_equal(a, opt2.suggest(3))


# ----------------------------------------------------------------- EHVI
def test_ehvi_select_picks_as_the_jax_package():
    space_spec = [{"name": "x0", "type": "num", "lb": -2, "ub": 4},
                  {"name": "x1", "type": "num", "lb": -1, "ub": 1}]
    js, ts = JSpace(space_spec), DesignSpace(space_spec)
    X = js.sobol_sample_opt(12, seed=1).astype(np.float32)
    Y = np.stack([X[:, 0] ** 2 + X[:, 1], (X[:, 0] - 2.0) ** 2 - X[:, 1]], 1)
    Ys = (Y - Y.mean(0)) / Y.std(0)
    jo = J.GeneralBO(js, num_obj=2, model_config={"num_epochs": 8})
    to = O.GeneralBO(ts, num_obj=2, model_config={"num_epochs": 8}, device="cpu")
    for o in (jo, to):
        o.observe(js.inverse_transform(X), Y)
    jo.model = jget_model("multi_task", js, num_out=2, num_epochs=8)
    jo.model.fit(X, Ys)
    to.model = model_from_jax(jo.model, get_model("multi_task", ts, num_out=2, device="cpu"))
    cand = js.sobol_sample_opt(40, seed=5)
    want = jo._ehvi_select(cand, 4, Ys)
    key, us = jax.random.PRNGKey(jo.num_obs), []
    for _ in range(4):
        key, k = jax.random.split(key)
        us.append(np.array(jax.random.uniform(k, (2048, 2), jnp.float32)))
    got = to._ehvi_select(cand, 4, Ys, uniforms=us)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got}) == 4
    # from the generator seeded by the observation count: distinct picks
    drawn = to._ehvi_select(cand, 4, Ys)
    assert len({tuple(r) for r in drawn}) == 4


# ------------------------------------------------------------ embedding
@pytest.mark.parametrize("strategy", ["alebo", "hesbo"])
def test_gen_proj_matrix_bit_identical(strategy):
    for D_hi, D_lo, seed in ((20, 4, 0), (7, 3, 5)):
        np.testing.assert_array_equal(O.gen_proj_matrix(D_hi, D_lo, strategy, seed),
                                      J.gen_proj_matrix(D_hi, D_lo, strategy, seed))
    with pytest.raises(ValueError):
        O.gen_proj_matrix(4, 2, "nope")


# --------------------------------------------------------------- CMA-ES
def test_cma_sample_and_update_with_fed_normals():
    """Three generations: the JAX package samples from its key; the port
    samples from the same normals (the same points at C = I) and both
    update from the JAX points; states within 1e-5."""
    D, lam, mu = 3, 8, 4
    lb, ub = np.full(D, -2.0, np.float32), np.full(D, 2.0, np.float32)
    js = jcmaes._init_state(D, np.asarray([0.5, -0.3, 0.1]), 0.6)
    ts = tcmaes._init_state(D, np.asarray([0.5, -0.3, 0.1]), 0.6, "cpu")
    key = jax.random.PRNGKey(0)
    for g in range(3):
        key, k = jax.random.split(key)
        Xj = jcmaes._cma_sample(k, js, lam, mu, jnp.asarray(lb), jnp.asarray(ub))
        z = T(np.asarray(jax.random.normal(k, (lam, D), jnp.float32)))
        Xt = tcmaes._cma_sample(ts, lam, T(lb), T(ub), z=z)
        if g == 0:
            np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-5, atol=1e-5)
        assert ((Xt >= T(lb)) & (Xt <= T(ub))).all()
        y = np.asarray(((np.asarray(Xj) - 0.7) ** 2).sum(1, keepdims=True), np.float32)
        js = jcmaes._cma_update(js, Xj, jnp.asarray(y), lam, mu)
        ts = tcmaes._cma_update(ts, T(np.asarray(Xj)), T(y), lam, mu)
        for f in ("mean", "sigma", "C", "p_sigma", "p_c"):
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{f} at generation {g}")
        assert int(ts.count) == int(js.count) == g + 1


# ------------------------------------------------------------ Evolution
MIXED = [{"name": "x0", "type": "num", "lb": -2.0, "ub": 2.0},
         {"name": "k", "type": "int", "lb": 0, "ub": 9},
         {"name": "c", "type": "cat", "categories": ["a", "b", "c", "d"]}]


def test_evolution_survive_is_exact():
    js, ts = JSpace(MIXED), DesignSpace(MIXED)
    rng = np.random.default_rng(6)
    X = ts.sobol_sample_opt(30, seed=2).astype(np.float32)
    F = np.round(rng.standard_normal((30, 2)) * 2).astype(np.float32) / 2  # ties
    meta = jevolution._space_meta(js)
    Xj, Fj = jevolution._survive(jnp.asarray(X), jnp.asarray(F), meta, 17)
    Xt, Ft = tevolution._survive(T(X), T(F), 17)
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(Ft.numpy(), np.asarray(Fj))


def test_evolution_mate_with_fed_draws():
    js, ts = JSpace(MIXED), DesignSpace(MIXED)
    P, D = 24, ts.num_cols
    X = ts.sobol_sample_opt(P, seed=3).astype(np.float32)
    F = np.stack([(X ** 2).sum(1), ((X - 1.0) ** 2).sum(1)], 1).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jevolution._mate(key, jnp.asarray(X), jnp.asarray(F), jevolution._space_meta(js))
    # replay the JAX package's key splits (evolution.py:42 and the operators')
    k_sel, k_sbx, k_mut, k_cat = jax.random.split(key, 4)
    u = lambda kk: T(np.asarray(jax.random.uniform(kk, (P, D))))
    s1, s2, s3 = jax.random.split(k_sbx, 3)
    m1, m2 = jax.random.split(k_mut)
    c1, c2, c3 = jax.random.split(k_cat, 3)
    sel = T(np.asarray(jax.random.randint(k_sel, (2, P), 0, P)))
    dr = GenDraws(sel, u(s1), u(s2), u(s3), u(m1), u(m2), u(c1), u(c2), u(c3))
    got = tevolution._mate(T(X), T(F), meta_tensors(O.Evolution(ts, device="cpu").meta, "cpu"), dr)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ baselines
@pytest.mark.parametrize("name", ["RandomSearch", "HillClimbing", "SimulatedAnnealing",
                                  "MultiArmedBandit"])
def test_baselines_suggest_as_the_jax_package(name):
    spec = CONT + [{"name": "c", "type": "cat", "categories": ["a", "b", "c"]}]
    jo, to = getattr(J, name)(JSpace(spec)), getattr(O, name)(DesignSpace(spec))
    f = lambda df: _quad(df) + (df["c"].values == "b").reshape(-1, 1)
    for _ in range(5):
        a, b = jo.suggest(3), to.suggest(3)
        pd.testing.assert_frame_equal(b, a)
        jo.observe(a, f(a))
        to.observe(b, f(b))
    assert to.best_y == jo.best_y


# ------------------------------------------------------------ Bayesmark
def test_bayesmark_spaces_are_identical():
    assert tbm.BAYESMARK_API_CONFIGS == jbm.BAYESMARK_API_CONFIGS
    assert len(tbm.BAYESMARK_API_CONFIGS) == 8
    for model, cfg in tbm.BAYESMARK_API_CONFIGS.items():
        ts, js = O.parse_space_from_bayesmark(cfg), J.parse_space_from_bayesmark(cfg)
        assert ts.param_order == js.param_order
        assert [type(ts.params[n]).__name__ for n in ts.param_order] == \
            [type(js.params[n]).__name__ for n in js.param_order]
        np.testing.assert_array_equal(ts.opt_lb, js.opt_lb)
        np.testing.assert_array_equal(ts.opt_ub, js.opt_ub)
        Z = js.sobol_sample_opt(6, seed=1)
        np.testing.assert_array_equal(ts.sobol_sample_opt(6, seed=1), Z)
        pd.testing.assert_frame_equal(ts.inverse_transform(Z), js.inverse_transform(Z))


@pytest.mark.parametrize("model,dataset", [("SVM", "breast"), ("DT", "iris"), ("lasso", "diabetes")])
def test_bayesmark_task_losses_are_identical(model, dataset):
    tt, jt = tbm.BayesmarkTask(model, dataset), jbm.BayesmarkTask(model, dataset)
    df = jt.space.sample(3, seed=0)
    y = tt(df)
    assert y.shape == (3, 1) and np.isfinite(y).all()
    np.testing.assert_array_equal(y, jt(df))
    assert tt.name == jt.name


def test_bayesmark_scores_and_suite():
    assert tbm.normalized_score(1.0, 1.0, 0.0) == 0.0
    assert tbm.normalized_score(0.0, 1.0, 0.0) == 100.0
    assert tbm.normalized_score(0.5, 0.5, 0.5) == 100.0
    tasks = tbm.suite(models=("kNN",), datasets=("iris",))
    assert len(tasks) == 1 and tasks[0].name == "kNN-iris"


# ---------------------------------------------------------------- smoke
@pytest.mark.parametrize("name,kw", [
    ("BO", SMALL), ("HEBO", SMALL), ("NoisyOpt", SMALL), ("NoMR_BO", SMALL),
    ("CMAES", {}), ("Evolution", {"pop": 16}),
])
def test_optimizer_smoke(name, kw):
    space = DesignSpace(CONT)
    opt = getattr(O, name)(space, device="cpu", **kw)
    for it in range(6):
        rec = opt.suggest(4)
        assert len(rec) == 4
        X = space.transform(rec)
        assert np.isfinite(X).all() and (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
        y = _quad(rec)
        if it == 2:
            y[0, 0] = np.inf
        opt.observe(rec, y)
    assert np.isfinite(opt.best_y)


def test_nomr_switches_to_its_exploit_stage():
    space = DesignSpace(CONT)
    opt = O.NoMR_BO(space, eta=1.0, device="cpu", **SMALL)
    stages = []
    for _ in range(6):
        stages.append(opt.exploiting)
        rec = opt.suggest(1)
        opt.observe(rec, _quad(rec))
    assert stages[0] is False and (opt.exploiting == (opt.best_y < 1.0))
    assert opt.stage2.num_obs == opt.num_obs == 6


def test_cmaes_and_evolution_minimize():
    space = DesignSpace(CONT)
    cma = O.CMAES(space, lam=16, device="cpu")
    for _ in range(30):
        rec = cma.suggest()
        cma.observe(rec, _quad(rec))
    assert cma.best_y < 0.05
    evo = O.Evolution(space, pop=32, device="cpu")
    for _ in range(15):
        rec = evo.suggest()
        evo.observe(rec, _quad(rec))
    assert evo.best_y < 0.5


def test_general_bo_multi_objective():
    space = DesignSpace([{"name": "x0", "type": "num", "lb": -2, "ub": 4}])
    opt = O.GeneralBO(space, num_obj=2, device="cpu", model_config={"num_epochs": 8}, pop=16,
                      iters=8)
    for _ in range(6):
        rec = opt.suggest(2)
        assert len({tuple(r) for r in space.transform(rec)}) == 2
        opt.observe(rec, _bi(rec))
    Xpf, Ypf = opt.get_pf()
    assert len(Ypf) >= 1 and np.array_equal(opt.best_y, Ypf)
    assert np.all(Xpf["x0"].values > -1.0) and np.all(Xpf["x0"].values < 3.0)
    dominated = (Ypf[:, None, :] <= Ypf[None, :, :]).all(-1) & (Ypf[:, None, :] < Ypf[None, :, :]).any(-1)
    assert not dominated.any()
    assert len(opt.ehvi_time) == len(opt.fit_time) > 0


def test_general_bo_constrained():
    space = DesignSpace(CONT)

    def obj_con(df):
        x = df[["x0", "x1"]].values.astype(float)
        return np.hstack([np.sum(x ** 2, axis=1, keepdims=True), 1.0 - x[:, :1]])

    opt = O.GeneralBO(space, num_obj=1, num_constr=1, device="cpu",
                      model_config={"num_epochs": 8}, pop=16, iters=8)
    for _ in range(6):
        rec = opt.suggest(2)
        opt.observe(rec, obj_con(rec))
    assert opt.num_obs == 12 and len(opt.model.models) == 2
    assert np.isfinite(opt.best_y)


def test_contextual():
    space = DesignSpace(CONT)
    opt = O.HEBO_VectorContextual(space, context_params=["x1"], device="cpu",
                                  model_config={"num_epochs": 8}, pop=16, iters=8)
    for i in range(5):
        ctx = {"x1": float(i % 2)}
        rec = opt.suggest(2, context=ctx)
        assert np.allclose(rec["x1"].values.astype(float), ctx["x1"])
        opt.observe(rec, _quad(rec))
    with pytest.raises(ValueError):
        opt.suggest(1, context={"x0": 0.0})


def test_embedding_bo():
    D = 20
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -1, "ub": 1} for i in range(D)])

    def f(df):
        x = df[[f"x{i}" for i in range(D)]].values.astype(float)
        return np.sum(x[:, :3] ** 2, axis=1, keepdims=True)

    opt = O.HEBO_Embedding(space, eff_dim=4, strategy="hesbo", device="cpu",
                           model_config={"num_epochs": 8}, pop=16, iters=8)
    for _ in range(6):
        rec = opt.suggest(3)
        assert rec.shape == (3, D)
        opt.observe(rec, f(rec))
    assert np.isfinite(opt.best_y) and len(opt.y) == 18


def test_macebo_rounds_on_svm_breast():
    task = tbm.BayesmarkTask("SVM", "breast")
    opt = O.MACEBO(task.api_config, device="cpu", model_config={"num_epochs": 8}, pop=16, iters=8)
    for _ in range(2):
        guesses = opt.suggest(4)
        assert len(guesses) == 4 and set(guesses[0]) == set(task.api_config)
        for g in guesses:
            for k, cfg in task.api_config.items():
                assert cfg["range"][0] <= g[k] <= cfg["range"][1]
        losses = task(pd.DataFrame(guesses))[:, 0]
        assert np.isfinite(losses).all()
        opt.observe(guesses, losses)
    assert np.isfinite(opt.best_y)


def test_sklearn_tuner_smoke():
    from sklearn.tree import DecisionTreeRegressor

    from hebo_tpu_torch.sklearn_tuner import sklearn_tuner

    rng = np.random.default_rng(0)
    X = rng.standard_normal((60, 3))
    y = X[:, 0] * 2 + rng.standard_normal(60) * 0.1
    conf = [{"name": "max_depth", "type": "int", "lb": 1, "ub": 6},
            {"name": "min_samples_leaf", "type": "int", "lb": 1, "ub": 8}]

    def r2(yt, yp):
        return 1 - np.sum((yt - yp) ** 2) / np.sum((yt - yt.mean()) ** 2)

    best, hist = sklearn_tuner(DecisionTreeRegressor, conf, X, y, metric=r2, max_iter=3, batch=2,
                               n_splits=3, report=True,
                               hebo_kw={"device": "cpu", "model_config": {"num_epochs": 8},
                                        "pop": 16, "iters": 8})
    assert 1 <= best["max_depth"] <= 6 and len(hist) == 3


def test_line_bo_smoke():
    space = DesignSpace(CONT)
    opt = O.LineBO(space, device="cpu", model_config={"num_epochs": 8})
    for _ in range(6):
        rec = opt.suggest(3)
        opt.observe(rec, _quad(rec))
    assert np.isfinite(opt.best_y) and opt.best_y <= float(np.min(opt.y[:3]))
