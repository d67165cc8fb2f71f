"""hebo_tpu_torch's GP path (ops/chol, models/gp) against hebo_tpu on CPU.

Both packages get the same numpy data and hyperparameters (carried over with
``params_from_jax`` / ``data_from_jax``); random draws of the JAX side are
fed to the port.

Tolerances (float32 on both sides, different summation orders and LAPACK
vs XLA factorizations):
* factors, caches, NLL value, predictions: rtol 1e-4 / atol 1e-4;
* NLL gradient: rtol 1e-3, atol 1e-3 (it goes through S⁻¹ = WᵀW);
* the 8-step pSGLD fit: atol 2e-3 on the parameters (the RMSProp
  preconditioner divides by √V, which amplifies rounding of small gradients).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.models.gp.gp import GPCore as JCore
from hebo_tpu.models.gp.gp import _make_data
from hebo_tpu.ops import chol as jchol
from hebo_tpu_torch.models.gp import GPCore, data_from_jax, params_from_jax
from hebo_tpu_torch.models.gp.gp import GPParams, make_data
from hebo_tpu_torch.ops import chol as tchol

N_OBS, N_PAD = 13, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cores(**kw):
    args = dict(numeric_dims=(0, 1, 2), cat_dims=(3,), num_categories=(3,), n_steps=8, **kw)
    return JCore(**args), GPCore(**args)


def _data():
    rng = np.random.default_rng(0)
    X = np.concatenate([rng.uniform(-1, 2, (N_OBS, 3)), rng.integers(0, 3, (N_OBS, 1))], 1)
    y = (np.sin(3 * X[:, :1]) + X[:, 1:2] ** 2 + 0.3 * X[:, 3:4]).astype(np.float32)
    jd = _make_data(X, y, (0, 1, 2), N_PAD)
    return jd, data_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()})


def _np_params(p):
    return {k: np.asarray(v) for k, v in p._asdict().items() if v is not None}


def _jax_p0(jcore, jd, R=2, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    return jax.vmap(lambda k: jcore.init_params(k, jd))(keys), keys


def test_make_data_matches():
    rng = np.random.default_rng(1)
    X = rng.uniform(size=(11, 4))
    y = rng.standard_normal((11, 1))
    y[3] = np.nan
    jd = _make_data(X, y, (0, 2), 16)
    td = make_data(X, y, (0, 2), 16, "cpu")
    for k, v in jd._asdict().items():
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(v))


def test_ladder_matches_and_all_rungs_fail():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((3, 24, 24)).astype(np.float32)
    K = A @ A.transpose(0, 2, 1) / 24 + 0.1 * np.eye(24, dtype=np.float32)
    B = rng.standard_normal((24, 4)).astype(np.float32)
    K[1] = B @ B.T / 4 - 1e-3 * np.eye(24, dtype=np.float32)  # needs rung 1e-2
    K[2] = -np.eye(24, dtype=np.float32) * 1e3  # every rung fails
    Lj, Wj, okj = (np.asarray(t) for t in jchol.batched_ladder_factor(jnp.asarray(K), jchol._LADDER))
    L, W, ok = tchol.batched_ladder_factor(torch.as_tensor(K), tchol.LADDER)
    np.testing.assert_array_equal(ok.numpy(), okj)
    assert okj.tolist() == [True, True, False]
    np.testing.assert_allclose(L[:2].numpy(), Lj[:2], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(W[:2].numpy(), Wj[:2], rtol=1e-4, atol=1e-4)

    # the NLL on the short fit ladder: K[1] is near-singular there, so swap
    # in a well-conditioned system; K[2] still fails every rung
    K[1] = K[0] + np.eye(24, dtype=np.float32)
    r = rng.standard_normal((3, 24, 1)).astype(np.float32)
    n_act = np.full(3, 24.0, np.float32)
    fj = jchol.make_masked_nll_batched((0.0, 1e-3))
    vj, (gKj, grj) = jax.value_and_grad(lambda a, b: jnp.sum(fj(a, b, n_act)), (0, 1))(
        jnp.asarray(K), jnp.asarray(r))
    Kt = torch.tensor(K, requires_grad=True)
    rt = torch.tensor(r, requires_grad=True)
    val = tchol.make_masked_nll_batched((0.0, 1e-3))(Kt, rt, torch.as_tensor(n_act))
    val.sum().backward()
    assert val[2].item() == 1e10 and float(jnp.sum(fj(jnp.asarray(K), jnp.asarray(r), n_act))) > 1e9
    assert Kt.grad[2].abs().max() == 0 and rt.grad[2].abs().max() == 0
    np.testing.assert_allclose(val.sum().item(), float(vj), rtol=1e-4)
    np.testing.assert_allclose(Kt.grad.numpy(), np.asarray(gKj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(grj), rtol=1e-3, atol=1e-3)


def _needs_rung(rng, n, lam_min):
    """A symmetric (n, n) matrix with eigenvalues in [0.5, 1] but one at
    ``lam_min`` (mean diagonal ≈ 0.75)."""
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    d = rng.uniform(0.5, 1.0, n)
    d[0] = lam_min
    return ((Q * d) @ Q.T).astype(np.float32)


@pytest.mark.parametrize("case", ["rung 2 and all fail", "all at rung 0"])
def test_ladder_jitter_and_skip_through_plain_k1(case):
    """The device-decided ladder (every rung launched, jitter inside K1,
    the matrices of earlier rungs skipped) through K1's plain version
    against hebo_tpu's lax.cond ladder: a matrix that first factors at
    rung 2 (jitter 1e-6 + 1e-4·scale), one that fails every rung, and a
    batch where every matrix factors at rung 0."""
    rng = np.random.default_rng(5)
    A = rng.standard_normal((3, 40, 40)).astype(np.float32)
    K = A @ A.transpose(0, 2, 1) / 40 + 0.1 * np.eye(40, dtype=np.float32)
    if case == "rung 2 and all fail":
        K[0] = _needs_rung(rng, 40, -2e-5)
        K[2] = -np.eye(40, dtype=np.float32) * 1e3
    Lj, Wj, okj = (np.asarray(t) for t in jchol.batched_ladder_factor(jnp.asarray(K), jchol._LADDER))
    L, W, ok = tchol.batched_ladder_factor(torch.as_tensor(K), tchol.LADDER)
    np.testing.assert_array_equal(ok.numpy(), okj)
    good = torch.as_tensor(okj)
    assert good.tolist() == ([True, True, False] if case != "all at rung 0" else [True] * 3)
    np.testing.assert_allclose(L[good].numpy(), Lj[okj], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(W[good].numpy(), Wj[okj], rtol=1e-4, atol=1e-4)
    for b in np.flatnonzero(~okj):  # failed every rung: non-finite L and W
        assert not torch.isfinite(L[b]).all() and not torch.isfinite(W[b]).all()
    if case == "rung 2 and all fail":
        # rung 2 is the first to factor K[0]: its L is K[0] + (1e-6 + 1e-4·scale) I's
        jit = 1e-6 + 1e-4 * np.float32(np.diagonal(K[0]).mean())
        L2 = np.linalg.cholesky(K[0].astype(np.float64) + jit * np.eye(40))
        np.testing.assert_allclose(L[0].numpy(), L2, rtol=1e-3, atol=1e-3)


def test_plain_k1_skip_keeps_out_and_adds_jitter():
    """chol_factor / chol_winv with jitter, skip and out on the CPU: a
    skipped matrix keeps what ``out`` held, the others are factored with the
    jitter on their diagonal (exactly K + jitter·I, not the padding)."""
    from hebo_tpu_torch.ops import chol_kernel as ck

    rng = np.random.default_rng(8)
    A = rng.standard_normal((3, 70, 70)).astype(np.float32)
    K = torch.as_tensor(A @ A.transpose(0, 2, 1) / 70 + 0.5 * np.eye(70, dtype=np.float32))
    jitter = torch.tensor([1e-3, 0.25, 2.0])
    Np = ck.padded_size(70)
    L = torch.full((3, Np, Np), 7.0)
    Wd = torch.full((3, Np // ck.TILE, ck.TILE, ck.TILE), 7.0)
    W = torch.full((3, Np, Np), 7.0)
    skip = torch.tensor([0, 1, 0], dtype=torch.int32)
    ck.chol_factor(K, jitter, skip, out=(L, Wd))
    ck.chol_winv(L, Wd, skip, out=W)
    assert (L[1] == 7.0).all() and (Wd[1] == 7.0).all() and (W[1] == 7.0).all()
    for b in (0, 2):
        Kj = K[b:b + 1] + jitter[b] * torch.eye(70)
        L0, Wd0 = ck.chol_factor(Kj)
        assert torch.equal(L[b], L0[0]) and torch.equal(Wd[b], Wd0[0])
        assert torch.equal(W[b], ck.chol_winv(L0, Wd0)[0])
        assert torch.equal(L[b, 70:, 70:], torch.eye(Np - 70))  # padding without jitter
    with pytest.raises(ValueError, match="out buffers"):
        ck.chol_factor(K, jitter, skip)
    ck.chol_factor(K, None, torch.ones(3, dtype=torch.int32), out=(L, Wd))  # all skipped
    assert (L[1] == 7.0).all()


def test_unbatched_masked_nll_and_safe_cholesky():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((10, 10)).astype(np.float32)
    K = A @ A.T / 10 + 0.05 * np.eye(10, dtype=np.float32)
    r = rng.standard_normal((10, 1)).astype(np.float32)
    Lj, okj = jchol.safe_cholesky(jnp.asarray(K))
    L, ok = tchol.safe_cholesky(torch.as_tensor(K))
    assert bool(ok) and bool(okj)
    np.testing.assert_allclose(L.numpy(), np.asarray(Lj), rtol=1e-4, atol=1e-5)
    fj = jchol.make_masked_nll((0.0, 1e-3))
    vj, gj = jax.value_and_grad(fj, (0, 1))(jnp.asarray(K), jnp.asarray(r), 10.0)
    Kt = torch.tensor(K, requires_grad=True)
    rt = torch.tensor(r, requires_grad=True)
    v = tchol.make_masked_nll((0.0, 1e-3))(Kt, rt, 10.0)
    v.backward()
    np.testing.assert_allclose(v.item(), float(vj), rtol=1e-4)
    np.testing.assert_allclose(Kt.grad.numpy(), np.asarray(gj[0]), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(gj[1]), rtol=1e-3, atol=1e-4)


def test_init_params_from_the_same_draws():
    jcore, tcore = _cores()
    jd, td = _data()
    p0j, keys = _jax_p0(jcore, jd)
    E = jcore.emb_dim
    z_emb, z_ls = [], []
    for k in keys:
        ke, kl = jax.random.split(k)
        z_emb.append(np.asarray(jax.random.normal(ke, (jcore.total_cats, E), jnp.float32)))
        z_ls.append(np.asarray(jax.random.normal(kl, (jcore.d_feat,), jnp.float32)))
    p0 = tcore.init_params(td, 2, draws=(np.stack(z_emb), np.stack(z_ls)))
    for k, v in _np_params(p0j).items():
        np.testing.assert_allclose(getattr(p0, k).numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)


def test_nanmedian_semantics():
    """jnp.nanmedian averages the middle pair; torch.nanmedian does not."""
    x = torch.tensor([1.0, 2.0, 3.0, 4.0, float("nan")])
    assert float(jnp.nanmedian(jnp.asarray(x.numpy()))) == 2.5
    assert torch.nanquantile(x, 0.5).item() == 2.5 and torch.nanmedian(x).item() == 2.0


def test_loss_value_and_gradient():
    jcore, tcore = _cores()
    jd, td = _data()
    p0j, _ = _jax_p0(jcore, jd)
    lj, gj = jax.value_and_grad(lambda P: jnp.sum(jcore.loss_batched(P, jd)))(p0j)
    leaves = [None if t is None else t.requires_grad_(True) for t in params_from_jax(_np_params(p0j))]
    loss = tcore.loss_batched(GPParams(*leaves), td)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jcore.loss_batched(p0j, jd)),
                               rtol=1e-4, atol=1e-4)
    live = [(f, t) for f, t in zip(GPParams._fields, leaves) if t is not None]  # noise_w: None
    grads = torch.autograd.grad(loss.sum(), [t for _, t in live], allow_unused=True)
    for (name, _), g in zip(live, grads):
        want = np.asarray(getattr(gj, name))
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=name)


def test_psgld_fit_with_fed_noise():
    jcore, tcore = _cores()
    jd, td = _data()
    p0j, _ = _jax_p0(jcore, jd, seed=3)
    key = jax.random.PRNGKey(11)
    pfj, lossj, sj = jcore.fit_from_batched(key, p0j, jd)
    # replay gp.py:630-641's key schedule: one normal per leaf per step
    shapes = [t.shape for t in jax.tree.leaves(p0j)]
    noise, k = [], key
    for _ in range(jcore.n_steps):
        k, ksub = jax.random.split(k)
        ks = jax.random.split(ksub, len(shapes))
        noise.append([np.asarray(jax.random.normal(kk, s, jnp.float32)) for kk, s in zip(ks, shapes)])
    pf, loss, s = tcore.fit_from_batched(params_from_jax(_np_params(p0j)), td,
                                         noise=lambda i: noise[i])
    for name in ("log_ls", "log_sc", "log_noise", "mean", "emb"):
        np.testing.assert_allclose(getattr(pf, name).numpy(), np.asarray(getattr(pfj, name)),
                                   atol=2e-3, err_msg=name)
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(sj, name)),
                                   atol=2e-3, err_msg=name)
    np.testing.assert_allclose(loss.numpy(), np.asarray(lossj), rtol=1e-3, atol=1e-3)


def test_adam_fit_matches():
    jcore, tcore = _cores(optimizer="adam")
    jd, td = _data()
    p0j, _ = _jax_p0(jcore, jd, seed=4)
    pfj, lossj, _ = jcore.fit_from_batched(jax.random.PRNGKey(0), p0j, jd)
    pf, loss, _ = tcore.fit_from_batched(params_from_jax(_np_params(p0j)), td)
    for name in ("log_ls", "log_sc", "log_noise", "mean", "emb"):
        np.testing.assert_allclose(getattr(pf, name).numpy(), np.asarray(getattr(pfj, name)),
                                   atol=2e-3, err_msg=name)
    np.testing.assert_allclose(loss.numpy(), np.asarray(lossj), rtol=1e-3, atol=1e-3)


def test_posterior_cache_and_predict_ensemble():
    jcore, tcore = _cores()
    jd, td = _data()
    sj, _ = _jax_p0(jcore, jd, seed=5)  # two "samples"
    cj = jcore.posterior_cache_batched(sj, jd)
    ts = params_from_jax(_np_params(sj))
    ct = tcore.posterior_cache_batched(ts, td)
    np.testing.assert_array_equal(ct.ok.numpy(), np.asarray(cj.ok))
    for name in ("L", "alpha", "Wf"):
        np.testing.assert_allclose(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    rng = np.random.default_rng(6)
    Xs = np.concatenate([rng.uniform(-1, 2, (9, 3)), rng.integers(0, 3, (9, 1))], 1).astype(np.float32)
    muj, varj = jcore.predict_ensemble(sj, cj, jd, jnp.asarray(Xs))
    mu, var = tcore.predict_ensemble(ts, ct, td, torch.as_tensor(Xs))
    np.testing.assert_allclose(mu.numpy(), np.asarray(muj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(varj), rtol=1e-4, atol=1e-4)
    # the triangular-solve branch (no cached W) agrees with the W branch
    mu2, var2 = tcore.predict_ensemble(ts, ct._replace(Wf=None), td, torch.as_tensor(Xs))
    np.testing.assert_allclose(var2.numpy(), var.numpy(), rtol=1e-4, atol=1e-5)


def test_large_bucket_names_the_cg_slice():
    """Bucket 2304 is above the default max_cholesky_size (2048): the cache
    takes the CG route (rank 128, 96 iterations), held against hebo_tpu.
    40 real rows: the preconditioner takes them, then the padded identity
    rows in index order (their diagonals tie at 1).  P and the pivots
    within 1e-5 of the JAX package's factor of the same Kt; α and the
    predictions, from a converged solve, rtol 1e-3 (tests/test_torch_cg.py)."""
    from hebo_tpu.ops import cg as jcg

    jcore, tcore = _cores()
    rng = np.random.default_rng(8)
    X = np.concatenate([rng.uniform(-1, 2, (40, 3)), rng.integers(0, 3, (40, 1))], 1)
    y = (np.sin(3 * X[:, :1]) + X[:, 1:2] ** 2).astype(np.float32)
    jd = _make_data(X, y, (0, 1, 2), 2304)
    td = make_data(X, y, (0, 1, 2), 2304, "cpu")
    E = tcore.emb_dim
    p = GPParams(*(torch.zeros((1,) + s) for s in [(3 + E,), (), (), (), (3, E), (3,), (3,)]))
    pj = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    cj = jax.jit(jax.vmap(lambda q: jcore.posterior_cache(q, jd)))(pj)
    ct = tcore.posterior_cache_batched(p, td)
    assert ct.L.shape == (1, 2304, 128) and ct.Kt.shape == (1, 2304, 2304)
    assert bool(ct.ok.all()) and bool(np.asarray(cj.ok).all()) and float(ct.res[0]) <= 1e-4
    Pj = np.asarray(jcg.pivoted_cholesky(jnp.asarray(ct.Kt[0].numpy()), 128))
    np.testing.assert_allclose(ct.L[0].numpy(), Pj, rtol=0, atol=1e-5)
    piv = np.argmax(np.abs(ct.L[0].numpy()), axis=0)  # each column's largest entry is its pivot
    np.testing.assert_array_equal(np.sort(piv[:40]), np.arange(40))
    np.testing.assert_array_equal(piv[40:], np.arange(40, 128))
    rel = lambda a, b: np.abs(a - np.asarray(b)).max() / np.abs(np.asarray(b)).max()
    assert rel(ct.alpha.numpy(), cj.alpha) <= 1e-3
    Xs = np.concatenate([rng.uniform(-1, 2, (9, 3)), rng.integers(0, 3, (9, 1))], 1).astype(np.float32)
    muj, varj = jax.jit(jcore.predict_ensemble)(pj, cj, jd, jnp.asarray(Xs))
    mu, var = tcore.predict_ensemble(p, ct, td, torch.as_tensor(Xs))
    assert rel(mu.numpy(), muj) <= 1e-3 and rel(var.numpy(), varj) <= 1e-3
