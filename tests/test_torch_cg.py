"""hebo_tpu_torch's large-N GP route (ops/cg, the CG posterior, the
subsampled fit) against hebo_tpu on CPU.

The same numpy inputs go through both packages (the JAX package's functions
under ``jax.jit``, as its GP wrapper runs them); fitted hyperparameters are
carried over with ``params_from_jax``.  Tolerances (float32 on both sides):
* the pivoted-Cholesky factor: the same pivots exactly, P within 1e-5;
* the Woodbury preconditioner apply: rtol 1e-4 / atol 1e-5 (the port
  multiplies by W = L⁻¹ of the k×k factor where the JAX package solves
  with L);
* anything that goes through PCG (solutions, residuals, α, predictions):
  rtol 1e-3 with an atol of 1e-3 of the largest value, on solves that
  converge (relative residual ≤ 1e-4); the residual of a column frozen
  under tol = 1e-5 within atol 1e-5.  A solve stopped far from convergence
  (f32 CG stalls near 1e-2 on small-noise systems) carries the rounding
  differences of every iteration: there the port's CG posterior is held
  against the port's dense one with the JAX package's own tolerances
  (tests/test_cg.py: μ rtol / atol 2e-2, σ² rtol 5e-2 / atol 2e-2);
* at the GP level the preconditioner is held against the JAX package's
  ``pivoted_cholesky`` of the port's own Kt: a stationary kernel's diagonal
  entries are equal up to the Gram's rounding, so the first pivots are
  chosen among rounding-level ties, which the two Grams break differently;
* the port's K1 ladder cache at bucket 2304 against the JAX package's
  per-sample dense cache: L, μ, σ² rtol / atol 1e-4, as the dense caches
  of test_torch_gp; α rtol 1e-3 (float32 solve of a 2300-point system
  with noise 1e-2); σ² rtol 1e-4 with atol 1e-5 of the prior variance,
  from which the explained variance is subtracted, and within 5e-6 of it
  of the float64 posterior variance;
* the subsample of the large-N fit: exactly the same rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.models.gp import gp as jgp_mod
from hebo_tpu.models.gp.gp import GPCore as JCore
from hebo_tpu.models.gp.gp import _make_data
from hebo_tpu.ops import cg as jcg
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.models.gp import GPCore, data_from_jax, params_from_jax
from hebo_tpu_torch.models.gp.convert import cache_from_jax
from hebo_tpu_torch.models.gp.gp import GP
from hebo_tpu_torch.ops import cg as tcg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, rtol=1e-3):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=rtol * np.abs(b).max())


def _kernel_matrix(n, n_pad, seed, sc=0.8, noise=0.01):
    """A Matérn-like SPD system, padded with identity rows as ``_train_system``
    pads it."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 6))
    d = np.sqrt(3.0 * ((X[:, None] - X[None]) ** 2).sum(-1) / 4.0)
    K = np.eye(n_pad)
    K[:n, :n] = sc * (1 + d) * np.exp(-d) + noise * np.eye(n)
    return K.astype(np.float32)


def _jax_pivots(K, P, jitter=1e-6):
    """The JAX factor's pivots, replayed from its columns (cg.py:46-56)."""
    d = np.diagonal(K).astype(np.float32).copy()
    piv = []
    for i in range(P.shape[1]):
        j = int(np.argmax(d))
        piv.append(j)
        d = np.maximum(d - P[:, i] ** 2, np.float32(0.0))
        d[j] = 0.0
    return np.asarray(piv)


@pytest.mark.parametrize("n,n_pad,rank,sc", [(200, 200, 16, 0.8), (200, 200, 64, 0.8),
                                             (300, 384, 96, 0.5)])
def test_pivoted_cholesky_same_pivots(n, n_pad, rank, sc):
    """(300, 384): the padded identity rows (diagonal 1) tie with each other
    and, with outputscale + noise below 1, outrank the real rows' residuals
    once those fall under 1; argmax takes the first index."""
    K = _kernel_matrix(n, n_pad, n + rank, sc=sc)
    Pj = np.asarray(jcg.pivoted_cholesky(jnp.asarray(K), rank))
    Pt = tcg.pivoted_cholesky(torch.as_tensor(K)[None], rank)[0].numpy()
    piv = np.argmax(np.abs(Pt), axis=0)  # column i's largest entry, √d_j, sits at its pivot
    np.testing.assert_array_equal(piv, _jax_pivots(K, Pj))
    np.testing.assert_allclose(Pt, Pj, rtol=0, atol=1e-5)
    if n_pad > n:
        assert (piv >= n).sum() > 0  # padded rows were picked


def test_woodbury_precond_apply():
    K = _kernel_matrix(256, 256, 1)
    B = np.random.default_rng(2).standard_normal((256, 7)).astype(np.float32)
    Pj = jcg.pivoted_cholesky(jnp.asarray(K), 48)
    want = jcg.woodbury_precond_apply(Pj, jnp.float32(0.05))(jnp.asarray(B))
    Pt = torch.as_tensor(np.array(Pj))[None]
    delta = torch.tensor([0.05])
    apply = tcg.woodbury_precond_apply(Pt, delta, tcg.woodbury_factor(Pt, delta))
    got = apply(torch.as_tensor(B)[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("precond", [False, True])
def test_pcg_solve_with_early_columns(precond):
    """Columns 0-1 lie in a 2-dimensional eigenspace of K and column 2 is 0:
    without a preconditioner they converge in a few iterations and freeze,
    while the random columns 3-5 are still running at the end."""
    rng = np.random.default_rng(3)
    n = 160
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.geomspace(0.05, 5.0, n)
    K = ((Q * lam) @ Q.T).astype(np.float32)
    B = rng.standard_normal((n, 6))
    B[:, 0] = Q[:, 5] + 0.5 * Q[:, 100]
    B[:, 1] = 2.0 * Q[:, 7] - Q[:, 40]
    B[:, 2] = 0.0
    B = B.astype(np.float32)
    Kj = jnp.asarray(K)
    if precond:
        Pj = jcg.pivoted_cholesky(Kj, 32)
        apply_j = jcg.woodbury_precond_apply(Pj, jnp.float32(0.05))
        Pt, delta = torch.as_tensor(np.array(Pj))[None], torch.tensor([0.05])
        apply_t = tcg.woodbury_precond_apply(Pt, delta, tcg.woodbury_factor(Pt, delta))
    else:
        apply_j = apply_t = None
    Xj, rj = jcg.pcg_solve(lambda V: Kj @ V, jnp.asarray(B), precond_apply=apply_j, n_iters=12)
    Kt = torch.as_tensor(K)[None]
    Xt, rt = tcg.pcg_solve(lambda V: Kt @ V, torch.as_tensor(B)[None], precond_apply=apply_t,
                           n_iters=12)
    _close(Xt[0].numpy(), Xj)
    # a frozen column's residual is rounding noise under tol = 1e-5
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj), rtol=1e-3, atol=1e-5)
    if not precond:
        assert (np.asarray(rj)[:3] <= 1e-5).all() and (rt[0, :3] <= 1e-5).all()
        assert (np.asarray(rj)[3:] > 1e-3).all() and (rt[0, 3:] > 1e-3).all()
    assert (Xt[0, :, 2] == 0).all()


# ----------------------------------------------------------- GP posterior
def _gp_data(n, n_pad, seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-1, 2, (n, 3)), rng.integers(0, 3, (n, 1))], 1)
    y = (np.sin(3 * X[:, :1]) + X[:, 1:2] ** 2 + 0.3 * X[:, 3:4]
         + 0.05 * rng.standard_normal((n, 1))).astype(np.float32)
    jd = _make_data(X, y, (0, 1, 2), n_pad)
    return jd, data_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()}, device="cpu")


def _cores(**kw):
    args = dict(numeric_dims=(0, 1, 2), cat_dims=(3,), num_categories=(3,), n_steps=4, **kw)
    return JCore(**args), GPCore(**args)


def _samples(jcore, jd, S=2, seed=5):
    keys = jax.random.split(jax.random.PRNGKey(seed), S)
    sj = jax.vmap(lambda k: jcore.init_params(k, jd))(keys)
    return sj, params_from_jax({k: np.asarray(v) for k, v in sj._asdict().items() if v is not None}, device="cpu")


def _queries(n=9, seed=6):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1, 2, (n, 3)), rng.integers(0, 3, (n, 1))], 1).astype(np.float32)


def _same_preconditioner(cache, rank):
    """The cache's P against the JAX package's factor of the cache's Kt."""
    for Kt, P in zip(cache.Kt.numpy(), cache.L.numpy()):
        np.testing.assert_allclose(P, np.asarray(jcg.pivoted_cholesky(jnp.asarray(Kt), rank)),
                                   rtol=0, atol=1e-5)


def test_cg_posterior_cache_and_predict_ensemble():
    """N = 500 in bucket 512 above max_cholesky_size 128: the CG cache (P, α,
    ok) and the CG predict, from the port's own cache and from the JAX
    package's cache, to which the port adds Kt and the Woodbury factor."""
    kw = dict(max_cholesky_size=128, cg_rank=48, cg_iters=48)
    jcore, tcore = _cores(**kw)
    jd, td = _gp_data(500, 512)
    sj, st = _samples(jcore, jd)
    cj = jax.jit(jcore.posterior_cache_batched)(sj, jd)
    ct = tcore.posterior_cache_batched(st, td)
    assert ct.Wf is None and ct.Kt.shape == (2, 512, 512) and ct.Q.shape == (2, 512, 48)
    np.testing.assert_array_equal(ct.ok.numpy(), np.asarray(cj.ok))
    assert ct.ok.all() and (ct.res <= 1e-4).all()
    _same_preconditioner(ct, 48)
    _close(ct.alpha.numpy(), cj.alpha)
    Xs = _queries()
    muj, varj = jax.jit(jcore.predict_ensemble)(sj, cj, jd, jnp.asarray(Xs))
    from_jax = cache_from_jax({k: np.asarray(v) for k, v in cj._asdict().items() if v is not None}, device="cpu")
    from_jax = from_jax._replace(Kt=tcore._train_system(st, td)[0],
                                 Q=tcg.woodbury_factor(from_jax.L, tcore.noise_base(st)))
    for cache in (ct, from_jax):
        mu, var = tcore.predict_ensemble(st, cache, td, torch.as_tensor(Xs))
        _close(mu.numpy(), muj)
        _close(var.numpy(), varj)


@pytest.mark.parametrize("n,n_pad,mcs,route", [(100, 128, 64, "cg"), (2300, 2304, 4096, "dense"),
                                               (100, 128, 2048, "ladder")])
def test_posterior_cache_routes(n, n_pad, mcs, route):
    """``posterior_cache_batched``: CG above max_cholesky_size, as gp.py:746;
    below it the batched K1 ladder (with W = L⁻¹) at every bucket, where
    the JAX package factors each sample densely above bucket 2048 (the
    "dense" case): the numbers agree all the same."""
    jcore, tcore = _cores(max_cholesky_size=mcs, cg_rank=64, cg_iters=64)
    jd, td = _gp_data(n, n_pad, seed=n)
    sj, st = _samples(jcore, jd, S=1)
    cj = jax.jit(jcore.posterior_cache_batched)(sj, jd)
    ct = tcore.posterior_cache_batched(st, td)
    assert (ct.Kt is not None) == (route == "cg") and (ct.Wf is not None) == (route != "cg")
    assert (cj.Wf is not None) == (route == "ladder")
    assert ct.L.shape == np.asarray(cj.L).shape == ((1, n_pad, 64) if route == "cg" else (1, n_pad, n_pad))
    np.testing.assert_array_equal(ct.ok.numpy(), np.asarray(cj.ok))
    tol = 1e-3 if route == "cg" else 1e-4
    if route == "cg":
        assert (ct.res <= 1e-4).all()
        _same_preconditioner(ct, 64)
    else:
        _close(ct.L.numpy(), cj.L, rtol=1e-4)
    _close(ct.alpha.numpy(), cj.alpha, rtol=1e-3 if route != "ladder" else 1e-4)
    Xs = _queries(seed=n)
    muj, varj = jax.jit(jcore.predict_ensemble)(sj, cj, jd, jnp.asarray(Xs))
    mu, var = tcore.predict_ensemble(st, ct, td, torch.as_tensor(Xs))
    _close(mu.numpy(), muj, rtol=tol)
    if route != "dense":
        _close(var.numpy(), varj, rtol=tol)
        return
    # σ² = kss − kᵀK⁻¹k keeps 0.5 % of the prior variance kss here, so the
    # two float32 routes (W = L⁻¹ against triangular solves) differ by a
    # few ulp of kss: held against each other within 1e-5 kss, and the
    # port's within 5e-6 kss of the float64 posterior variance
    kss = float(torch.exp(st.log_sc)[0])
    np.testing.assert_allclose(var.numpy(), np.asarray(varj), rtol=tol, atol=1e-5 * kss)
    Kt, _ = tcore._train_system(st, td)
    Ks = tcore.gram_points(st, td.X, torch.as_tensor(Xs), td)[0].double() * td.mask.double()[:, None]
    v64 = kss - (Ks * torch.linalg.solve(Kt[0].double(), Ks)).sum(0)
    np.testing.assert_allclose(var.numpy()[:, 0], v64.numpy(), rtol=0, atol=5e-6 * kss)


SPECS = [{"name": f"x{i}", "type": "num", "lb": -3.0, "ub": 3.0} for i in range(3)] + [
    {"name": "c", "type": "cat", "categories": ["a", "b", "c"]}]


def _capture_fit_data(monkeypatch, jgp):
    """Record the subsample that the JAX GP's large-N fit is handed."""
    seen = {}
    orig = jgp._get_fit_fn_big

    def get(key_pair):
        fn = orig(key_pair)

        def fit_fn_big(key, data_fit, data_full):
            seen["data_fit"] = data_fit
            return fn(key, data_fit, data_full)

        return fit_fn_big

    monkeypatch.setattr(jgp, "_get_fit_fn_big", get)
    return seen


def test_gp_fit_large_n_route(monkeypatch):
    """300 points (one of them non-finite) above max_cholesky_size 128: the
    same 128-row subsample as the JAX package (bucket 128), the cache on
    all the data (bucket 384), and the port's CG cache from the JAX
    package's fitted samples equal to its own."""
    conf = dict(num_epochs=4, n_restarts=2, max_cholesky_size=128, cg_rank=128, cg_iters=96, seed=3)
    rng = np.random.default_rng(4)
    X = np.concatenate([rng.uniform(-3, 3, (300, 3)), rng.integers(0, 3, (300, 1))], 1).astype(np.float32)
    y = (np.sin(X[:, :1]) + 0.1 * X[:, 1:2] ** 2 + 0.2 * X[:, 3:4]).astype(np.float32)
    y[17] = np.nan
    jgp = jgp_mod.GP(JSpace(SPECS), **conf)
    seen = _capture_fit_data(monkeypatch, jgp)
    jgp.fit(X, y)
    tgp = GP(DesignSpace(SPECS), device="cpu", **conf)
    tgp.fit(X, y)
    assert tgp._seed == jgp._seed == 4
    assert tgp.fit_data.X.shape[0] == 128 and tgp.data.X.shape[0] == 384
    for name, v in seen["data_fit"]._asdict().items():
        np.testing.assert_array_equal(getattr(tgp.fit_data, name).numpy(), np.asarray(v), err_msg=name)
    st = params_from_jax({k: np.asarray(v) for k, v in jgp.samples._asdict().items() if v is not None}, device="cpu")
    ct = tgp.core.posterior_cache_batched(st, tgp.data)
    np.testing.assert_array_equal(ct.ok.numpy(), np.asarray(jgp.caches.ok))
    assert (ct.res <= 1e-4).all()
    _same_preconditioner(ct, 128)
    _close(ct.alpha.numpy(), jgp.caches.alpha)
    mu, var = tgp.predict(X[:20])
    assert np.isfinite(mu).all() and (var > 0).all()


def test_cg_posterior_matches_dense():
    """tests/test_cg.py's contract on the port: the same fitted state, its
    posterior through the dense route and through CG forced by
    max_cholesky_size 128 (rank 96, 128 iterations), at N = 512."""
    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -3.0, "ub": 3.0} for i in range(4)])
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (512, 4)).astype(np.float32)
    y = (np.sin(X[:, :1]) + 0.1 * X[:, 1:2] ** 2).astype(np.float32)
    Xq = rng.uniform(-3, 3, (32, 4)).astype(np.float32)
    kw = dict(num_epochs=15, n_restarts=1, seed=7)
    dense = GP(space, device="cpu", **kw).fit(X, y)
    cg = GP(space, device="cpu", max_cholesky_size=128, cg_rank=96, cg_iters=128, **kw)
    cg.data, cg.samples, cg.params = dense.data, dense.samples, dense.params
    cg.caches = cg.core.posterior_cache_batched(dense.samples, dense.data)
    assert cg.caches.Kt is not None and dense.caches.Wf is not None and bool(cg.caches.ok.all())
    mu_d, v_d = dense.predict(Xq)
    mu_c, v_c = cg.predict(Xq)
    np.testing.assert_allclose(mu_c, mu_d, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(v_c, v_d, rtol=5e-2, atol=2e-2)
