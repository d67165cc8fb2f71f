"""MCBO's presets in hebo_tpu_torch (the diffusion, HED and conditional
kernels; BOCS's linear model; Mean, Sigma, CEI and Thompson sampling; the
SA, interleaved, bandit and GA acquisition optimizers; ``BO_ALGOS``) against
hebo_tpu on CPU.

Tolerances (float32 on both sides, different summation orders):
* kernel functions: 1e-6 absolute; the HED anchors bit for bit;
* GP loss, caches, predictions: rtol / atol 1e-4; loss gradient 1e-3 (as
  tests/test_torch_gp.py);
* ``lin_reg``'s host features and the mle / bayes estimators exactly; one
  Gibbs sweep with the JAX package's draws fed in: rtol 1e-4; a full chain's
  coefficient mean within 4 Monte-Carlo standard errors (batch means);
* acquisition values: rtol / atol 1e-5;
* acquisition optimizers on a JAX-fitted GP carried across, with the same
  seed and trust-region state: the same categorical picks, numerics within
  1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.acq_optimizers import mcbo_opts as jopts
from hebo_tpu.acquisitions import acq as jacq
from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.models import get_model as jget_model
from hebo_tpu.models import linreg as jlinreg
from hebo_tpu.models.gp import kernels as jk
from hebo_tpu.models.gp.gp import GPCore as JCore
from hebo_tpu.models.gp.gp import _make_data
from hebo_tpu.optimizers.bo_builder import BO_ALGOS as JALGOS
from hebo_tpu.trust_region.casmo import CasmopolitanTrManager as JTR
from hebo_tpu_torch.acq_optimizers import GenDraws
from hebo_tpu_torch.acq_optimizers import mcbo_opts as topts
from hebo_tpu_torch.acquisitions import acq as tacq
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.models import get_model
from hebo_tpu_torch.models import linreg as tlinreg
from hebo_tpu_torch.models.gp import GPCore, GPParams, cache_from_jax, data_from_jax, params_from_jax
from hebo_tpu_torch.models.gp import kernels as tk
from hebo_tpu_torch.optimizers.bo_builder import BO_ALGOS
from hebo_tpu_torch.tasks import PestControlTask
from hebo_tpu_torch.trust_region import CasmopolitanTrManager

N_OBS, N_PAD = 13, 16
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
    """The file's time is the JAX package's compiles: they run at XLA's
    lowest backend optimization level here (about half the compile time; the
    same operations, so the same values up to float32 rounding).  The flag
    is not in JAX's in-memory jit key, so it is restored before conftest's
    module teardown clears the jit caches; the persistent cache's key holds
    it."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _np(t):
    return {k: np.asarray(v) for k, v in t._asdict().items() if v is not None}


# ------------------------------------------------------------------ kernels
def test_kernel_functions():
    rng = np.random.default_rng(0)
    N, M, C, G = 7, 5, 4, 2
    c1 = rng.integers(0, 3, (N, C)).astype(np.float32)
    c2 = rng.integers(0, 3, (M, C)).astype(np.float32)
    lam = rng.uniform(0.2, 2.0, (3, C)).astype(np.float32)
    grams = rng.uniform(0.0, 1.0, (3, G, N, M)).astype(np.float32)
    c2g = np.asarray([0, -1, 1], np.int32)
    nvals = np.asarray([3, 4, 2, 5], np.float32)
    table = rng.standard_normal((9, 6)).astype(np.float32)
    i1, i2 = rng.integers(0, 9, N), rng.integers(0, 9, M)
    ls6 = rng.uniform(0.5, 2.0, 6).astype(np.float32)
    anchors = rng.integers(0, 3, (16, C)).astype(np.float32)
    got = {
        "conditional_batched": tk.conditional_transformed_overlap(T(c1), T(c2), T(grams), T(c2g), T(lam)),
        "ordinal": tk.ordinal_kernel(T(c1), T(c2), T(lam[0]), T(nvals)),
        "diffusion": tk.diffusion_kernel(T(c1), T(c2), T(lam[0]), T(nvals)),
        "diffusion_batched": tk.diffusion_kernel(T(c1), T(c2), T(lam), T(nvals)),
        "hed": tk.hed_embed(T(c1), T(anchors)),
        "warp_rbf": tk.feature_warp_rbf(T(i1), T(i2), T(table), T(ls6)),
        "warp_cosine": tk.feature_warp_cosine(T(i1), T(i2), T(table)),
    }
    J = jnp.asarray
    want = {
        "conditional_batched": np.stack([jk.conditional_transformed_overlap(
            J(c1), J(c2), J(grams[b]), J(c2g), J(lam[b])) for b in range(3)]),
        "ordinal": jk.ordinal_kernel(J(c1), J(c2), J(lam[0]), J(nvals)),
        "diffusion": jk.diffusion_kernel(J(c1), J(c2), J(lam[0]), J(nvals)),
        "diffusion_batched": np.stack([jk.diffusion_kernel(J(c1), J(c2), J(lam[b]), J(nvals))
                                       for b in range(3)]),
        "hed": jk.hed_embed(J(c1), J(anchors)),
        "warp_rbf": jk.feature_warp_rbf(J(i1), J(i2), J(table), J(ls6)),
        "warp_cosine": jk.feature_warp_cosine(J(i1), J(i2), J(table)),
    }
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6, err_msg=k)
    # the conditional kernel's rules: mismatch 0, match without group 1
    assert (got["conditional_batched"] <= 1.0 + 1e-6).all()


def test_hed_anchors_bit_identical():
    args = dict(numeric_dims=(0,), cat_dims=tuple(range(1, 8)), num_categories=(2, 3, 5, 2, 4, 2, 7),
                cat_kernel="hed")
    for m in (16, 5):
        j, t = JCore(hed_num_anchors=m, **args), GPCore(hed_num_anchors=m, **args)
        assert t.hed_anchors.dtype == j.hed_anchors.dtype
        np.testing.assert_array_equal(t.hed_anchors, j.hed_anchors)
        assert (t.n_feat_dims, t.n_cat_param, t.d_feat) == (j.n_feat_dims, j.n_cat_param, j.d_feat)


# ----------------------------------------------------------------------- GP
COND = dict(cond_groups=((0,), (1, 2)), cond_cat_to_group=(0, -1, 1))


def _cores(cat_kernel, n_num, L=5, V=3):
    extra = COND if cat_kernel == "conditional_to" else {}
    args = dict(numeric_dims=tuple(range(n_num)), cat_dims=tuple(range(n_num, n_num + L)),
                num_categories=(V,) * L, cat_kernel=cat_kernel, n_steps=8, **extra)
    return JCore(hed_num_anchors=6, **args), GPCore(hed_num_anchors=6, **args)


def _data(n_num, L=5, V=3):
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.uniform(-1, 2, (N_OBS, n_num)), rng.integers(0, V, (N_OBS, L))], 1)
    y = (np.sin(3 * X[:, :1]) if n_num else 0.0) + (X[:, n_num:] == 1).sum(1, keepdims=True)
    jd = _make_data(X, np.asarray(y, np.float32), tuple(range(n_num)), N_PAD)
    return jd, data_from_jax(_np(jd), device="cpu")


def _jax_p0(jcore, jd, R=2, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    return jax.vmap(lambda k: jcore.init_params(k, jd))(keys)


GP_CASES = [("diffusion", 0), ("diffusion", 2), ("hed", 2), ("conditional_to", 3)]


@pytest.fixture(scope="module", params=GP_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def gp_case(request):
    """One case's JAX side in one jitted program (two restarts' initial
    parameters, their losses and gradient, the posterior cache and the
    ensemble prediction at 9 queries), and the port's core and data."""
    cat_kernel, n_num = request.param
    jcore, tcore = _cores(cat_kernel, n_num)
    jd, td = _data(n_num)
    rng = np.random.default_rng(6)
    Xs = np.concatenate([rng.uniform(-1, 2, (9, n_num)), rng.integers(0, 3, (9, 5))], 1).astype(np.float32)

    def jax_side(keys, Xs):
        P = jax.vmap(lambda k: jcore.init_params(k, jd))(keys)
        loss = jcore.loss_batched(P, jd)
        grad = jax.grad(lambda Q: jnp.sum(jcore.loss_batched(Q, jd)))(P)
        cache = jcore.posterior_cache_batched(P, jd)
        return P, loss, grad, cache, jcore.predict_ensemble(P, cache, jd, Xs)

    P, loss, grad, cache, pred = jax.jit(jax_side)(jax.random.split(jax.random.PRNGKey(0), 2),
                                                   jnp.asarray(Xs))
    return dict(jcore=jcore, tcore=tcore, td=td, Xs=Xs, p=_np(P), loss=np.asarray(loss), grad=grad,
                cache=cache, pred=[np.asarray(t) for t in pred])


def test_gpcore_layout(gp_case):
    j, t = gp_case["jcore"], gp_case["tcore"]
    assert (t.d_feat, t.n_feat_dims, t.n_cat_param) == (j.d_feat, j.n_feat_dims, j.n_cat_param)
    assert {k: v.shape for k, v in gp_case["p"].items()} == {
        k: tuple(v.shape) for k, v in params_from_jax(gp_case["p"], device="cpu")._asdict().items() if v is not None}


def test_gpcore_loss(gp_case):
    loss = gp_case["tcore"].loss_batched(params_from_jax(gp_case["p"], device="cpu"), gp_case["td"])
    np.testing.assert_allclose(loss.numpy(), gp_case["loss"], rtol=1e-4, atol=1e-4)


def test_gpcore_gradient(gp_case):
    leaves = [None if t is None else t.requires_grad_(True) for t in params_from_jax(gp_case["p"], device="cpu")]
    loss = gp_case["tcore"].loss_batched(GPParams(*leaves), gp_case["td"])
    live = [(f, t) for f, t in zip(GPParams._fields, leaves) if t is not None]
    grads = torch.autograd.grad(loss.sum(), [t for _, t in live], allow_unused=True)
    for (name, _), g in zip(live, grads):
        want = np.asarray(getattr(gp_case["grad"], name))
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=name)


def test_gpcore_cache_and_predict_ensemble(gp_case):
    tcore, td, cj = gp_case["tcore"], gp_case["td"], gp_case["cache"]
    ts = params_from_jax(gp_case["p"], device="cpu")
    ct = tcore.posterior_cache_batched(ts, td)
    np.testing.assert_array_equal(ct.ok.numpy(), np.asarray(cj.ok))
    for name in ("L", "alpha", "Wf"):
        np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    mu, var = tcore.predict_ensemble(ts, ct, td, torch.as_tensor(gp_case["Xs"]))
    np.testing.assert_allclose(mu.numpy(), gp_case["pred"][0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var.numpy(), gp_case["pred"][1], rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------------ lin_reg
LR_SPACE = [
    {"name": "x0", "type": "num", "lb": -1.0, "ub": 1.0},
    {"name": "a", "type": "cat", "categories": ["u", "v", "w"]},
    {"name": "b", "type": "cat", "categories": ["p", "q", "r", "s"]},
    {"name": "f", "type": "bool"},
]


def _lr_data(n=30, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([rng.uniform(-1, 1, n), rng.integers(0, 3, n), rng.integers(0, 4, n),
                         rng.integers(0, 2, n)]).astype(float)
    y = (X[:, :1] - 0.7 * (X[:, 1:2] == 2) + 0.4 * X[:, 3:4] * (X[:, 2:3] == 1)
         + 0.05 * rng.standard_normal((n, 1)))
    return X, y


def _lr_pair(**conf):
    return (jget_model("lin_reg", JSpace(LR_SPACE), num_out=1, **conf),
            get_model("lin_reg", DesignSpace(LR_SPACE), num_out=1, device="cpu", **conf))


def test_linreg_features_identical():
    jm, tm = _lr_pair()
    X, _ = _lr_data()
    np.testing.assert_array_equal(tm._featurize(X), jm._featurize(X))
    Xf = X.astype(np.float32)
    np.testing.assert_array_equal(tm._featurize_t(T(Xf)).numpy(),
                                  np.asarray(jm._featurize_jnp(jnp.asarray(Xf))))


@pytest.mark.parametrize("estimator", ["mle", "bayes"])
def test_linreg_host_estimators_identical(estimator):
    jm, tm = _lr_pair(estimator=estimator)
    X, y = _lr_data()
    jm.fit(X, y)
    tm.fit(X, y)
    np.testing.assert_array_equal(tm.w_draws, jm.w_draws)
    np.testing.assert_array_equal(tm.noise, jm.noise)
    for a, b in zip(tm.predict(X[:7]), jm.predict(X[:7])):
        np.testing.assert_array_equal(a, b)
    Xq = X[:7].astype(np.float32)
    for a, b in zip(tm.predict_pure(tm.state, T(Xq)), jm.predict_pure(jm.state, jnp.asarray(Xq))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _jax_gibbs_draws(key, n_gibbs, n, p):
    """Replay ``_horseshoe_gibbs``'s key schedule (linreg.py:45-72)."""

    def step(k, _):
        k, k1, k2, k3, k4, k5, k6 = jax.random.split(k, 7)
        g = lambda kk, a, shape: jax.random.gamma(kk, a, shape=shape)
        return k, (jax.random.normal(k1, (p,)), g(k2, 1.0, (p,)), g(k3, 1.0, (p,)),
                   g(k4, 0.5 * (p + 1.0), (1,))[0], g(k5, 1.0, (1,))[0], g(k6, 0.5 * (n + p), (1,))[0])

    _, cols = jax.jit(lambda k: jax.lax.scan(step, k, None, length=n_gibbs))(key)
    return tlinreg.GibbsDraws(*(T(np.array(c)) for c in cols))


def _lr_phi():
    jm, _ = _lr_pair()
    X, y = _lr_data()
    Phi = jm._featurize(X).astype(np.float32)
    return Phi, ((y - y.mean()) / y.std()).astype(np.float32)


def test_horseshoe_sweeps_with_fed_draws():
    """Sweep 2 of a 2-sweep chain (the kept half), so the first sweep's whole
    carry too, with the JAX package's draws."""
    Phi, ys = _lr_phi()
    key = jax.random.PRNGKey(3)
    want = np.asarray(jlinreg._horseshoe_gibbs(key, jnp.asarray(Phi), jnp.asarray(ys), n_gibbs=2))
    draws = _jax_gibbs_draws(key, 2, *Phi.shape)
    got = tlinreg.horseshoe_gibbs(T(Phi), T(ys), 2, draws=draws).numpy()
    assert got.shape == want.shape == (1, Phi.shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _batch_means(draws, n_batches=10):
    b = draws[: len(draws) // n_batches * n_batches].reshape(n_batches, -1, draws.shape[1]).mean(1)
    return draws.mean(0), b.std(0, ddof=1) / np.sqrt(n_batches)


def test_horseshoe_chain_mean_against_jax():
    """Independent chains of 2000 sweeps (the second halves kept): the
    coefficient means within 4 Monte-Carlo standard errors (batch means)."""
    Phi, ys = _lr_phi()
    jw = np.asarray(jlinreg._horseshoe_gibbs(jax.random.PRNGKey(0), jnp.asarray(Phi), jnp.asarray(ys),
                                             n_gibbs=2000))
    tw = tlinreg.horseshoe_gibbs(T(Phi), T(ys), 2000, generator=torch.Generator().manual_seed(0)).numpy()
    (mj, sj), (mt, st) = _batch_means(jw), _batch_means(tw)
    assert np.all(np.abs(mt - mj) <= 4 * np.sqrt(sj ** 2 + st ** 2) + 1e-6), (mt - mj, sj, st)


def test_linreg_thompson_draw_is_one_function_per_seed():
    _, tm = _lr_pair(n_gibbs=60)
    X, y = _lr_data()
    tm.fit(X, y)
    assert tm.w_draws.shape == (30, tm._featurize(X[:1]).shape[1])
    Xq = T(X[:9].astype(np.float32))
    ts = tacq.ThompsonSampling()
    f = lambda seed, Xs: ts.eval_pure(tm, tm.state, tacq.AcqParams(seed=seed), Xs)[:, 0].numpy()
    np.testing.assert_array_equal(f(3, Xq), f(3, Xq))
    assert not np.allclose(f(3, Xq), f(4, Xq))
    # one coefficient vector for every batch of one search (up to the
    # batch's summation order)
    np.testing.assert_allclose(f(3, torch.cat([T(X[9:14].astype(np.float32)), Xq]))[5:], f(3, Xq),
                               rtol=1e-6, atol=1e-6)
    # the draw is one of the kept coefficient vectors
    Phi = tm._featurize(X[:9])
    mu_y, sd_y = tm._y_stats
    vals = (Phi @ tm.w_draws.T) * sd_y + mu_y
    assert np.abs(vals - f(3, Xq)[:, None]).max(0).min() < 1e-4


# ------------------------------------------------------------- acquisitions
class _Fixed:
    """A model whose predictive (mu, var) is fixed."""

    def __init__(self, mu, var):
        self.mu, self.var = mu, var

    def predict_pure(self, state, X):
        return self.mu, self.var


def _two_out(seed=0, P=40):
    rng = np.random.default_rng(seed)
    mu = np.column_stack([rng.normal(0, 1, P), rng.normal(0.5, 2, P)]).astype(np.float32)
    var = np.column_stack([rng.uniform(0.01, 2.0, P), rng.uniform(0.1, 3.0, P)]).astype(np.float32)
    mu[:4, 0] = [9.0, 12.0, -3.0, 30.0]
    var[:4, 0] = [0.04, 0.01, 1.0, 0.5]
    return mu, var


CEI_CASES = [dict(num_constr=0), dict(num_constr=1, lambdas=[0.3]),
             dict(num_constr=1, lambdas=[-1.0], augmented_ei=True), dict(num_constr=0, augmented_ei=True)]


@pytest.mark.parametrize("tau", [0.2, float("nan"), float("inf")])
@pytest.mark.parametrize("conf", CEI_CASES)
def test_cei_values(conf, tau):
    mu, var = _two_out()
    want = jacq.CEI(**conf).eval_pure(_Fixed(jnp.asarray(mu), jnp.asarray(var)), None,
                                      jacq.AcqParams(tau=jnp.float32(tau), noise=jnp.float32(0.3)), None)
    got = tacq.CEI(**conf).eval_pure(_Fixed(T(mu), T(var)), None, tacq.AcqParams(tau=tau, noise=0.3), None)
    assert got.shape == (40, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mean_sigma_values():
    mu, var = _two_out(1)
    mu, var = mu[:, :1], var[:, :1]
    var[5] = 0.0  # below the 1e-12 floor
    for j, t in ((jacq.Mean(), tacq.Mean()), (jacq.Sigma(), tacq.Sigma())):
        want = j.eval_pure(_Fixed(jnp.asarray(mu), jnp.asarray(var)), None, jacq.AcqParams(), None)
        got = t.eval_pure(_Fixed(T(mu), T(var)), None, tacq.AcqParams(), None)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_thompson_without_joint_sampler_shares_one_eps():
    mu, var = _two_out(2)
    m = _Fixed(T(mu[:, :1]), T(var[:, :1]))
    ts = tacq.ThompsonSampling()
    X = torch.zeros((40, 1))
    a = ts.eval_pure(m, None, tacq.AcqParams(seed=5), X)
    np.testing.assert_array_equal(a.numpy(), ts.eval_pure(m, None, tacq.AcqParams(seed=5), X).numpy())
    eps = (a - m.mu) / torch.sqrt(m.var)
    assert float(eps.std()) < 1e-5
    assert not torch.equal(a, ts.eval_pure(m, None, tacq.AcqParams(seed=6), X))


# ------------------------------------------------------- acquisition optimizers
MIXED = [
    {"name": "x0", "type": "num", "lb": -2.0, "ub": 2.0},
    {"name": "x1", "type": "num", "lb": -1.0, "ub": 3.0},
    {"name": "c0", "type": "cat", "categories": ["a", "b", "c"]},
    {"name": "c1", "type": "cat", "categories": ["p", "q", "r", "s"]},
]
CATONLY = [{"name": f"c{i}", "type": "cat", "categories": ["a", "b", "c"]} for i in range(5)]


@pytest.fixture(scope="module")
def fitted():
    """A JAX transformed-overlap GP fitted on 20 Sobol points of the mixed
    space, and the port's GP carrying its samples, caches and data."""
    js, ts = JSpace(MIXED), DesignSpace(MIXED)
    X = js.sobol_sample_opt(20, seed=0)
    y = (X[:, :1] ** 2 + X[:, 1:2] - (X[:, 2:3] == 1) + 0.5 * (X[:, 3:4] == 2)).astype(np.float32)
    jm = jget_model("gp", js, num_out=1, cat_kernel="transformed_overlap", num_epochs=10)
    jm.fit(X, y)
    tm = get_model("gp", ts, num_out=1, device="cpu", cat_kernel="transformed_overlap")
    tm.params = params_from_jax(_np(jm.params), device="cpu")
    tm.samples = params_from_jax(_np(jm.samples), device="cpu")
    tm.caches = cache_from_jax(_np(jm.caches), device="cpu")
    tm.data = data_from_jax(_np(jm.data), device="cpu")
    return dict(js=js, ts=ts, X=X, jm=jm, tm=tm,
                jp=jacq.AcqParams(tau=jnp.float32(-1.2), kappa=jnp.float32(2.0), key=jax.random.PRNGKey(20)),
                tp=tacq.AcqParams(tau=-1.2, kappa=2.0, seed=20))


def _trs(f, center_row=3, seed=0):
    jtr, ttr = JTR(f["js"], seed=seed), CasmopolitanTrManager(f["ts"], seed=seed)
    for tr in (jtr, ttr):
        tr.register_center(f["X"][center_row])
    return jtr, ttr


def _same_picks(got, want, space):
    cd, nd = space.cat_dims, space.numeric_dims
    np.testing.assert_array_equal(got[:, cd], want[:, cd])
    np.testing.assert_allclose(got[:, nd], want[:, nd], rtol=1e-4, atol=1e-4)


def test_interleaved_descent(fitted):
    """``n_grad_steps`` gradient steps on the numerics, clipped to the TR
    box: autograd through the port's posterior against ``jax.grad``."""
    f = fitted
    jtr, ttr = _trs(f)
    lb, ub = ttr.numeric_bounds()
    np.testing.assert_array_equal(lb, jtr.numeric_bounds()[0])
    X0 = ttr.sample_within_tr(8)
    X0[0] = f["X"][3]  # the TR center, an observed point
    jo = jopts.InterleavedSearchAcqOptimizer(f["js"])
    want = np.asarray(jo._grad_fn(f["jm"], jacq.EI())(f["jm"].state, f["jp"], jnp.asarray(X0, jnp.float32),
                                                     jnp.asarray(lb, jnp.float32), jnp.asarray(ub, jnp.float32)))
    got = topts.InterleavedSearchAcqOptimizer(f["ts"]).descend(f["tm"], tacq.EI(), f["tp"], X0, lb, ub)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - X0).max() > 1e-3  # the descent moved
    np.testing.assert_array_equal(got[:, 2:], X0[:, 2:])


def test_interleaved_search(fitted):
    f = fitted
    jtr, ttr = _trs(f)
    kw = dict(n_suggestions=2, x_observed=f["X"], seed=20)
    want = jopts.InterleavedSearchAcqOptimizer(f["js"]).optimize(f["jm"], jacq.EI(), f["jp"], tr_manager=jtr, **kw)
    got = topts.InterleavedSearchAcqOptimizer(f["ts"]).optimize(f["tm"], tacq.EI(), f["tp"], tr_manager=ttr, **kw)
    _same_picks(got, want, f["ts"])


def test_mixed_mab(fitted):
    f = fitted
    kw = dict(n_suggestions=2, x_observed=f["X"], seed=21)
    jo, to = jopts.MixedMabAcqOptimizer(f["js"]), topts.MixedMabAcqOptimizer(f["ts"])
    want = jo.optimize(f["jm"], jacq.EI(), f["jp"], **kw)
    got = to.optimize(f["tm"], tacq.EI(), f["tp"], **kw)
    _same_picks(got, want, f["ts"])
    assert [{c: int(v) for c, v in d.items()} for d in to.last_cats] == \
        [{c: int(v) for c, v in d.items()} for d in jo.last_cats]
    for o in (jo, to):
        o.update_rewards(o.last_cats[0], 0.7)
    for c in to.weights:
        np.testing.assert_array_equal(to.weights[c], jo.weights[c])


def test_simulated_annealing(fitted):
    f = fitted
    jtr, ttr = _trs(f)
    kw = dict(n_suggestions=3, x_observed=f["X"], seed=22)
    want = jopts.SimulatedAnnealingAcqOptimizer(f["js"], n_walkers=16, n_rounds=12).optimize(
        f["jm"], jacq.EI(), f["jp"], tr_manager=jtr, **kw)
    got = topts.SimulatedAnnealingAcqOptimizer(f["ts"], n_walkers=16, n_rounds=12).optimize(
        f["tm"], tacq.EI(), f["tp"], tr_manager=ttr, **kw)
    _same_picks(got, want, f["ts"])


def _jax_ga_draws(key, n_gens, P, D):
    """Replay the JAX package's NSGA-II key schedule (evolution.py:158)."""
    out, k = [], key
    for _ in range(n_gens):
        k, k_sel, k_sbx, k_mut, k_cat = jax.random.split(k, 5)
        u = lambda kk: T(np.asarray(jax.random.uniform(kk, (P, D))))
        s1, s2, s3 = jax.random.split(k_sbx, 3)
        m1, m2 = jax.random.split(k_mut)
        c1, c2, c3 = jax.random.split(k_cat, 3)
        sel = T(np.array(jax.random.randint(k_sel, (2, P), 0, P)))
        out.append(GenDraws(sel, u(s1), u(s2), u(s3), u(m1), u(m2), u(c1), u(c2), u(c3)))
    return out


def test_genetic_algo_with_fed_draws(fitted):
    f = fitted
    jtr, ttr = _trs(f)
    P, iters, seed = 16, 3, 23
    kw = dict(n_suggestions=2, x_observed=f["X"], seed=seed)
    want = jopts.GeneticAlgoAcqOptimizer(f["js"], pop=P, iters=iters).optimize(
        f["jm"], jacq.EI(), f["jp"], tr_manager=jtr, **kw)
    draws = _jax_ga_draws(jax.random.PRNGKey(seed), iters, P, f["ts"].num_cols)
    got = topts.GeneticAlgoAcqOptimizer(f["ts"], pop=P, iters=iters).optimize(
        f["tm"], tacq.EI(), f["tp"], tr_manager=ttr, draws=lambda g: draws[g], **kw)
    _same_picks(got, want, f["ts"])


def test_bocs_pipeline_sa_ts_linreg_mle():
    """BOCS's acquisition path (SA over TS of ``lin_reg``) with the mle
    estimator, whose one coefficient vector makes TS deterministic in both
    packages: the same picks."""
    js, ts = JSpace(CATONLY), DesignSpace(CATONLY)
    X = ts.sobol_sample_opt(24, seed=1)
    y = (-(X == 0).sum(1, keepdims=True) + 0.3 * (X[:, :1] == 2)).astype(float)
    jm = jget_model("lin_reg", js, num_out=1, estimator="mle").fit(X, y)
    tm = get_model("lin_reg", ts, num_out=1, device="cpu", estimator="mle").fit(X, y)
    kw = dict(n_suggestions=2, x_observed=X, seed=24)
    want = jopts.SimulatedAnnealingAcqOptimizer(js).optimize(
        jm, jacq.ThompsonSampling(), jacq.AcqParams(key=jax.random.PRNGKey(24)), **kw)
    got = topts.SimulatedAnnealingAcqOptimizer(ts).optimize(
        tm, tacq.ThompsonSampling(), tacq.AcqParams(seed=24), **kw)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- presets
def _obj_mixed(df):
    x = df["x0"].values.astype(float) + 0.5 * df["x1"].values.astype(float)
    return (x ** 2 - (df["c0"].values == "b") - 0.5 * (df["c1"].values == "q")).reshape(-1, 1)


def _obj_cat(df):
    return -np.stack([(df[f"c{i}"].values == "a") for i in range(5)]).sum(0).astype(float).reshape(-1, 1)


def test_bo_algos_keys_and_builders():
    assert sorted(BO_ALGOS) == sorted(JALGOS)
    fields = ("model_id", "acq_opt_id", "acq_func_id", "tr_id", "name")
    for k, b in BO_ALGOS.items():
        assert [getattr(b, a) for a in fields] == [getattr(JALGOS[k], a) for a in fields]


@pytest.mark.parametrize("name", sorted(BO_ALGOS))
def test_preset_runs(name):
    builder = dataclasses.replace(BO_ALGOS[name], model_kwargs={"num_epochs": 10})
    cat_only = name in ("COMBO", "BOCS", "BOSS", "BOiLS")
    space = DesignSpace(CATONLY if cat_only else MIXED)
    obj = _obj_cat if cat_only else _obj_mixed
    opt = builder.build_bo(space, n_init=6, device="cpu")
    for _ in range(5):
        rec = opt.suggest(2)
        assert len(rec) == 2
        opt.observe(rec, obj(rec))
    assert opt.num_obs == 10 and np.isfinite(opt.best_y)
    assert len(opt.fit_time) == len(opt.acq_time) == 2


def test_rducb_builds_and_suggests():
    """RDUCB at its defaults (a random tree over the dims, Adam, the
    message-passing optimizer over a 16-point grid per dim, LCB): valid,
    new suggestions."""
    space = DesignSpace(MIXED)
    opt = BO_ALGOS["RDUCB"].build_bo(space, n_init=4, device="cpu")
    assert type(opt.model).__name__ == "RDGP" and type(opt.acq_optimizer).__name__ == \
        "MessagePassingOptimizer" and type(opt.acq_func).__name__ == "LCB"
    warm = space.sample(8, seed=3)
    opt.observe(warm, _obj_mixed(warm))
    rec = opt.suggest(1)
    X = space.transform(rec)
    assert np.isfinite(X).all() and np.array_equal(X, space.round_opt(X))
    assert tuple(np.round(X[0], 6)) not in {tuple(np.round(r, 6)) for r in space.transform(opt.X)}


def test_thompson_seed_is_the_observation_count():
    """Every acquisition evaluation of one BOCS suggest sees one seed, the
    number of observations (the JAX package's PRNGKey(num_obs))."""
    space = DesignSpace(CATONLY)
    opt = dataclasses.replace(BO_ALGOS["BOCS"], model_kwargs={"n_gibbs": 40}).build_bo(
        space, n_init=4, device="cpu")
    seeds, ev = [], opt.acq_func.eval_pure
    opt.acq_func.eval_pure = lambda m, st, p, X: (seeds.append(p.seed), ev(m, st, p, X))[1]
    rec = opt.suggest(2)
    opt.observe(rec, _obj_cat(rec))
    opt.suggest(2)
    assert seeds == [] and opt.num_obs == 2
    rec = opt.suggest(2)
    opt.observe(rec, _obj_cat(rec))
    rec = opt.suggest(1)
    assert len(seeds) == 1 + opt.acq_optimizer.n_rounds and set(seeds) == {4}
    # the pest-control task is the port's own copy
    pest = PestControlTask(n_stations=6)
    assert pest(pest.space.sample(3, seed=0)).shape == (3, 1)
