"""The GP variants in hebo_tpu_torch (SVGP, DKL, the uncertain-input GP,
CompBO's compositional optimizers, and the differentiable ladder factor
under SVGP's ELBO) against hebo_tpu on CPU.

Tolerances (float32 on both sides unless said):
* ``ladder_factor_inv``'s gradient against ``torch.linalg.cholesky``'s
  autograd: 1e-5 of the largest entry; ``gradcheck`` in float64;
* SVGP's negative ELBO and its gradient, Kmm's factor and the predictions
  on carried-across parameters: rtol 1e-4 (atol 1e-4 × the largest
  |value|); the factor of the ill-conditioned A and w = A⁻¹ Kmn r / σ²:
  1e-3, since each package's float32 w lies 2-4e-4 from a float64 solve;
  a few Adam steps from the JAX package's initial draws: 1e-4;
* DKL's features and loss gradient: 1e-4;
* ``expected_rbf`` and ``mmd_nystrom_kernel``: 1e-5; the uncertain GP's
  predictions on carried-across parameters: 1e-4;
* each CompBO method with the JAX package's ε fed in: the same iterates
  after 4 steps (1e-4) and the same scores (1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.acq_optimizers.compositional import CompositionalAcqOptimizer as JComp
from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.models import get_model as jget_model
from hebo_tpu.models.gp import uncertain_gp as jugp
from hebo_tpu_torch import HEBO
from hebo_tpu_torch.acq_optimizers.compositional import CompDraws, CompositionalAcqOptimizer
from hebo_tpu_torch.acquisitions.acq import AcqParams
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.models import get_model
from hebo_tpu_torch.models.gp import data_from_jax, model_from_jax, params_from_jax
from hebo_tpu_torch.models.gp import uncertain_gp as tugp
from hebo_tpu_torch.models.gp.svgp import SVGPParams
from hebo_tpu_torch.models.gp.tree import tree_leaves
from hebo_tpu_torch.ops.chol import ladder_factor_inv

CONT = [{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(3)]
MIXED = CONT + [{"name": "c", "type": "cat", "categories": ["a", "b", "c"]}]
CATONLY = [{"name": "c0", "type": "cat", "categories": ["a", "b", "c"]},
           {"name": "c1", "type": "cat", "categories": ["x", "y"]}]
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


def _xy(space, n=24, seed=0):
    X = space.sobol_sample_opt(n, seed=seed).astype(np.float32)
    y = (np.sin(2 * X[:, :1]) + X[:, -1:] ** 2 - 0.3 * X[:, 1:2]).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    """JAX models fitted once on MIXED and carried into the port:
    {name: (jax model, port model)}."""
    js, ts = JSpace(MIXED), DesignSpace(MIXED)
    X, y = _xy(ts)
    out = {}
    for name, conf in (("svgp", {"num_epochs": 5, "num_inducing": 8}), ("dkl", {"num_epochs": 5}),
                       ("uncertain_gp", {"num_epochs": 5})):
        jm = jget_model(name, js, **conf)
        jm.fit(X, y)
        out[name] = (jm, model_from_jax(jm, get_model(name, ts, device="cpu", **conf)))
    return out


# ------------------------------------------------- differentiable ladder
def _spd(B, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((B, n, n), generator=g, dtype=dtype)
    return A @ A.transpose(-1, -2) / n + 0.5 * torch.eye(n, dtype=dtype)


def test_ladder_factor_inv_gradcheck_float64():
    K = _spd(2, 6, torch.float64).requires_grad_(True)
    sym = lambda K: 0.5 * (K + K.transpose(-1, -2))
    assert torch.autograd.gradcheck(lambda K: ladder_factor_inv(sym(K), (0.0,), 0.0)[:2], (K,))


@pytest.mark.parametrize("B,n", [(1, 8), (3, 20), (2, 70)])
def test_ladder_factor_inv_gradient_matches_cholesky_autograd(B, n):
    K = _spd(B, n, torch.float32, seed=n)
    g = torch.Generator().manual_seed(1)
    gL, gW = torch.randn((2, B, n, n), generator=g)
    K1 = K.clone().requires_grad_(True)
    L, W, ok = ladder_factor_inv(K1)
    assert bool(ok.all())
    got, = torch.autograd.grad((L * gL).sum() + (W * gW).sum(), K1)
    K2 = K.clone().requires_grad_(True)
    L2 = torch.linalg.cholesky(K2 + 1e-6 * torch.eye(n))
    want, = torch.autograd.grad((L2 * gL).sum() + (torch.linalg.inv(L2) * gW).sum(), K2)
    _close(got.numpy(), want.numpy(), 1e-5)


# ------------------------------------------------------------------- SVGP
def test_svgp_neg_elbo_and_gradient(fitted):
    jm, tm = fitted["svgp"]
    p = jax.tree.map(lambda t: t * 0.97, jm.params)
    lj, gj = jax.jit(jax.value_and_grad(lambda P: jm.core.neg_elbo(P, jm.data)))(p)
    gp = params_from_jax(_np(p.gp), device="cpu")
    leaves = [t.requires_grad_(True) for t in tree_leaves(gp)]
    Z = T(np.asarray(p.Z))[None].requires_grad_(True)
    tp = SVGPParams(gp=type(gp)(*leaves, None), Z=Z)
    lt = tm.core.neg_elbo(tp, tm.data)
    _close(lt.detach().numpy(), [float(lj)], 1e-4)
    grads = torch.autograd.grad(lt.sum(), [gp.log_ls, gp.log_sc, gp.log_noise, gp.mean, gp.emb, Z])
    want = (gj.gp.log_ls, gj.gp.log_sc, gj.gp.log_noise, gj.gp.mean, gj.gp.emb, gj.Z)
    for g, w in zip(grads, want):
        _close(g[0].numpy(), w, 1e-4)


def test_svgp_cache_and_predict(fitted):
    jm, tm = fitted["svgp"]
    Lm, La, w = (np.asarray(t) for t in jm._cache)
    _close(tm._cache.Lm[0].numpy(), Lm, 1e-4)
    # A = Kmm + Kmn Knm / σ² has a condition number near 1e4 here: w is a
    # solve with it, and each package's float32 w lies 2-4e-4 of its largest
    # entry from a float64 solve, so the two are held at 1e-3
    _close(tm._cache.La[0].numpy(), La, 1e-3)
    _close(tm._cache.w[0].numpy(), w, 1e-3)
    Xq = DesignSpace(MIXED).sobol_sample_opt(10, seed=3).astype(np.float32)
    mu, var = tm.predict(Xq)
    mj, vj = jm.predict(Xq)
    _close(mu, mj, 1e-4)
    _close(var, vj, 1e-4)
    assert tm.noise.shape == (1,) and np.isfinite(tm.noise).all()


def test_svgp_fit_from_the_jax_packages_draws(fitted):
    """``init_params`` with the JAX package's draws (svgp.py:121-131: the
    GP's init from k1, the inducing rows and jitter from k2), then the Adam
    steps: the JAX model's fitted (gp, Z)."""
    jm, _ = fitted["svgp"]
    ts = DesignSpace(MIXED)
    tm = get_model("svgp", ts, device="cpu", num_epochs=5, num_inducing=8)
    core = jm.core
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    ke, kl = jax.random.split(k1)
    z_emb = 0.0 + np.asarray(jax.random.normal(ke, (core.total_cats, core.emb_dim), jnp.float32))
    z_ls = np.asarray(jax.random.normal(kl, (core.d_feat,), jnp.float32))
    n_pad, F = jm.data.X.shape[0], core.n_feat_dims
    idx = np.asarray(jax.random.randint(k2, (core.num_inducing,), 0, n_pad))
    z = np.asarray(jax.random.normal(k2, (core.num_inducing, F), jnp.float32))
    data = data_from_jax(_np(jm.data), device="cpu")
    p0 = tm.init_params(data, draws=((z_emb[None], z_ls[None]), idx, z))
    pf = tm.fit_params(p0, data)
    for got, want in zip(tree_leaves(pf.gp), tree_leaves(params_from_jax(_np(jm.params.gp), device="cpu"))):
        _close(got.numpy(), want.numpy(), 1e-4)
    _close(pf.Z[0].numpy(), np.asarray(jm.params.Z), 1e-4)


@pytest.mark.parametrize("epochs", [5, 50])
def test_svgp_gradient_terms_bound_float32(epochs):
    """The card check's bound (``bench/svgp_grad_probe.gradient_terms``) on
    the CPU: each leaf's float64 gradient is at most M, the sum of its
    terms' magnitudes, and the CPU's float32 gradient lies within
    (n − 1)·ε₃₂·M of the float64 one."""
    from hebo_tpu_torch.bench import svgp_grad_probe as probe

    m = probe.fit(0, epochs, device="cpu")
    g64, M = probe.gradient_terms(m)
    _, g32 = probe.gradient(m, "cpu")
    n = m.params.Z.shape[1] * (m.data.X.shape[0] + m.params.Z.shape[1])
    for k in probe.LEAVES:
        assert bool((g64[k].abs() <= M[k] * (1 + 1e-9)).all()), k
        assert bool(((g32[k].double() - g64[k]).abs() <= (n - 1) * probe.EPS32 * M[k]).all()), k


@pytest.mark.parametrize("spec", [CONT, MIXED, CATONLY], ids=["cont", "mixed", "cat"])
def test_svgp_cross_product(spec):
    """tests/test_models.py's SVGP case in the port."""
    space = DesignSpace(spec)
    X = space.transform(space.sample(24, seed=0))
    rng = np.random.default_rng(0)
    y = X.astype(float).sum(1, keepdims=True) + 0.05 * rng.standard_normal((24, 1))
    m = get_model("svgp", space, device="cpu", num_epochs=30, num_inducing=8).fit(X, y)
    mu, var = m.predict(X)
    assert mu.shape == var.shape == (24, 1) and np.isfinite(mu).all() and (var > 0).all()
    assert np.sqrt(np.mean((mu - y) ** 2)) < 1.5 * (np.std(y) + 1e-6)


# -------------------------------------------------------------------- DKL
def test_dkl_features_and_loss_gradient(fitted):
    jm, tm = fitted["dkl"]
    p = jax.tree.map(lambda t: t[0], jm.samples)
    fj = jm.core.features(p, jm.data.X, jm.data)
    ft = tm.core.features(tm.samples, tm.data.X, tm.data)[0]
    _close(ft.numpy(), fj, 1e-4)
    lj, gj = jax.jit(jax.value_and_grad(lambda P: jnp.sum(jm.core.loss_batched(P, jm.data))))(jm.samples)
    leaves = params_from_jax(_np(jm.samples), device="cpu")
    leaves = type(leaves)(*[None if t is None else t.requires_grad_(True) for t in leaves])
    lt = tm.core.loss_batched(leaves, tm.data)
    _close(lt.detach().numpy(), [float(lj)], 1e-4)
    grads = torch.autograd.grad(lt.sum(), [leaves.log_ls, leaves.emb, leaves.log_noise])
    for g, w in zip(grads, (gj.log_ls, gj.emb, gj.log_noise)):
        _close(g.numpy(), w, 1e-4)
    Xq = DesignSpace(MIXED).sobol_sample_opt(6, seed=2).astype(np.float32)
    mu, var = tm.predict(Xq)
    mj, vj = jm.predict(Xq)
    _close(mu, mj, 1e-4)
    _close(var, vj, 1e-4)


def test_dkl_init_params_with_fed_draws(fitted):
    jm, tm = fitted["dkl"]
    key = jax.random.PRNGKey(3)
    pj = jm.core.init_params(key, jm.data)
    kw, kl = jax.random.split(key)
    draws = (np.asarray(jax.random.normal(kw, (tm.core._n_w, 1), jnp.float32))[None],
             np.asarray(jax.random.normal(kl, (tm.core.feat_dim,), jnp.float32))[None])
    pt = tm.core.init_params(tm.data, 1, draws=draws)
    for f in ("log_ls", "log_sc", "log_noise", "mean", "emb"):
        _close(getattr(pt, f)[0].numpy(), getattr(pj, f), 1e-6)


def test_dkl_fits_nonstationary():
    """tests/test_misc_models.py's DKL case in the port."""
    space = DesignSpace([{"name": "x0", "type": "num", "lb": -1, "ub": 1},
                         {"name": "x1", "type": "num", "lb": -1, "ub": 1}])
    X = space.transform(space.sample(40, seed=0))
    y = np.sign(X[:, :1]) * X[:, :1] ** 2 + 0.3 * X[:, 1:]
    m = get_model("dkl", space, device="cpu", num_epochs=80, feat_dim=4).fit(X, y)
    mu, var = m.predict(X)
    assert np.isfinite(mu).all() and (var > 0).all()
    assert np.sqrt(np.mean((mu - y) ** 2)) < np.std(y)


# ---------------------------------------------------------- uncertain GP
def test_expected_rbf_and_mmd_nystrom_kernel():
    rng = np.random.default_rng(0)
    x1, x2 = rng.standard_normal((5, 3)).astype(np.float32), rng.standard_normal((4, 3)).astype(np.float32)
    ls = np.asarray([0.5, 1.0, 2.0], np.float32)
    s = np.asarray([0.1, 0.3, 0.0], np.float32)
    Kj = jax.jit(jugp.expected_rbf)(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), jnp.asarray(s),
                                    jnp.asarray(s))
    Kt = tugp.expected_rbf(T(x1), T(x2), T(ls), T(s), T(s))
    _close(Kt.numpy(), Kj, 1e-5)
    S1 = rng.standard_normal((4, 8, 2)).astype(np.float32)
    S2 = rng.standard_normal((3, 8, 2)).astype(np.float32)
    lm = rng.standard_normal((16, 2)).astype(np.float32)
    Mj = jax.jit(jugp.mmd_nystrom_kernel, static_argnums=(3, 4))(
        jnp.asarray(S1), jnp.asarray(S2), jnp.asarray(lm), 1.0, 1.0)
    Mt = tugp.mmd_nystrom_kernel(T(S1), T(S2), T(lm), gamma=1.0, feat_ls=1.0)
    _close(Mt.numpy(), Mj, 1e-5)
    # identical distributions → MMD 0 → 1 on the diagonal
    Ms = tugp.mmd_nystrom_kernel(T(S1), T(S1), T(lm), gamma=1.0, feat_ls=1.0)
    np.testing.assert_allclose(torch.diagonal(Ms).numpy(), 1.0, atol=1e-3)


def test_uncertain_gp_predict_and_prior_diag(fitted):
    jm, tm = fitted["uncertain_gp"]
    p = jax.tree.map(lambda t: t[0], jm.samples)
    _close(tm.core.prior_diag(tm.samples).numpy(), [float(jm.core.prior_diag(p))], 1e-5)
    Xq = DesignSpace(MIXED).sobol_sample_opt(7, seed=5).astype(np.float32)
    mu, var = tm.predict(Xq)
    mj, vj = jm.predict(Xq)
    _close(mu, mj, 1e-4)
    _close(var, vj, 1e-4)


# ------------------------------------------------------------------ CompBO
def _jax_comp_draws(key, method, n_steps, n_mc, P):
    """compositional.py:96-147's key schedule, as ``CompDraws``."""
    n = lambda k: np.asarray(jax.random.normal(k, (n_mc, P)))
    steps, k = [], key
    for _ in range(n_steps):
        if method == "adam":
            k, ks = jax.random.split(k)
            steps.append([n(ks)])
        else:
            k, k1, k2 = jax.random.split(k, 3)
            steps.append([n(k1), n(k2)])
    return CompDraws(init=T(n(key)), steps=T(np.asarray(steps)), final=T(n(jax.random.fold_in(key, 7))))


@pytest.mark.parametrize("method", ["cadam", "scgd", "ascgd", "nasa", "adam"])
def test_compositional_iterates_with_fed_draws(fitted, method):
    """On the carried-across uncertain-input GP (any model's
    ``predict_pure`` serves)."""
    jm, tm = fitted["uncertain_gp"]
    ts = tm.space
    X0 = ts.sobol_sample_opt(6, seed=1).astype(np.float32)
    kw = dict(method=method, n_steps=4, n_mc=8)
    key = jax.random.PRNGKey(2)
    Xj, sj = JComp(jm.space, **kw)._build_run(jm)(key, jm.state, jnp.float32(-0.5), jnp.asarray(X0))
    opt = CompositionalAcqOptimizer(ts, **kw)
    Xt, st = opt.run(tm, tm.state, -0.5, T(X0), _jax_comp_draws(key, method, 4, 8, 6))
    _close(Xt.numpy(), Xj, 1e-4)
    _close(st.numpy(), sj, 1e-4)


@pytest.mark.parametrize("method", ["cadam", "adam"])
def test_compositional_optimizer_improves_qei(method):
    """tests/test_compbo_airbo.py's case in the port (its generator's ε)."""
    space = DesignSpace(CONT[:2])
    X = space.transform(space.sample(20, seed=0))
    y = (X ** 2).sum(1, keepdims=True)
    gp = get_model("gp", space, device="cpu", num_epochs=20).fit(X, y)
    opt = CompositionalAcqOptimizer(space, method=method, n_steps=32, n_starts=8)
    rec = opt.optimize(gp, None, AcqParams(tau=float(y.min())), n_suggestions=2, seed=0)
    assert rec.shape == (2, 2) and np.isfinite(rec).all()
    assert np.mean((rec ** 2).sum(1)) < np.mean((X ** 2).sum(1))
    with pytest.raises(ValueError, match="unknown method"):
        CompositionalAcqOptimizer(space, method="sgd")


# -------------------------------------------------------------------- HEBO
@pytest.mark.parametrize("name", ["svgp", "dkl", "uncertain_gp", "gp_rd"])
def test_hebo_generic_route_with_the_variants(name):
    space = DesignSpace(MIXED)
    opt = HEBO(space, model_name=name, device="cpu", pop=16, iters=3, model_config={"num_epochs": 6})
    warm = space.sample(12, seed=1)
    f = lambda df: (df[[c["name"] for c in CONT]].values.astype(float) ** 2).sum(1, keepdims=True)
    opt.observe(warm, f(warm))
    for _ in range(2):
        rec = opt.suggest(4)
        X = space.transform(rec)
        assert len(rec) == 4 and np.isfinite(X).all() and np.array_equal(X, space.round_opt(X))
        opt.observe(rec, f(rec))
    assert type(opt.model).__name__ != "GP" and len(opt.fit_time) == len(opt.acq_time) == 2
    assert not opt._graphs and np.isfinite(opt.best_y)
