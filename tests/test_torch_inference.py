"""hebo_tpu_torch's hyperparameter samplers and Thompson draws against
hebo_tpu on CPU.

The samplers' deterministic pieces are held step by step with the JAX
package's own draws fed to the port: the JAX side's per-step states come out
of its ``lax.scan`` carries through ``jax.debug.callback`` (its module's
``lax`` is wrapped for the test), the chains run one by one as
``hmc_sample`` maps them.  Tolerance 1e-4 (float32 on both sides); a step
whose accept decision sits within 1e-3 of its threshold ends the comparison
there, and the test says so.  The whole samplers are held to the JAX
package's Gaussian-recovery bands (tests/test_inference.py), and at the GP
level the port's posterior mean lies within ±2σ of the JAX GP's MAP fit.
Thompson draws (``joint_sample_scaled``) with JAX's z: 1e-4 (dense and CG).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import hebo_tpu.models.gp.inference as jinf
from hebo_tpu.models.gp.gp import GPCore as JCore
from hebo_tpu.models.gp.gp import _make_data
from hebo_tpu_torch.models.gp import GPCore, data_from_jax, params_from_jax
from hebo_tpu_torch.models.gp.inference import (HMCDraws, _leapfrog, _value_and_grad, hmc_sample,
                                                smc_sample, svi_fit)
from hebo_tpu_torch.models.gp.tree import Flat

N_OBS, N_PAD = 13, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(p):
    return {k: np.asarray(v) for k, v in p._asdict().items() if v is not None}


def _setup(R=2, seed=0, **kw):
    """A 2-D GP (no categoricals) of both packages, its data, R parameter
    sets from the JAX init, and the JAX package's unbatched log-density."""
    args = dict(numeric_dims=(0, 1), cat_dims=(), num_categories=(), **kw)
    jcore, tcore = JCore(**args), GPCore(**args)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 2, (N_OBS, 2))
    jd = _make_data(X, np.sin(3 * X[:, :1]) + X[:, 1:] ** 2, (0, 1), N_PAD)
    td = data_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()}, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    p0 = jax.vmap(lambda k: jcore.init_params(k, jd))(keys)
    return jcore, tcore, jd, td, p0


def _flat_normals(key, tree, n=None):
    """``_tree_randn_like(key, tree)`` flattened as ``ravel_pytree``: (dim,),
    or (n, dim) for a tree whose leaves lead with n."""
    leaves = jax.tree.leaves(jinf._tree_randn_like(key, tree))
    return np.concatenate([np.asarray(l).reshape((-1,) if n is None else (n, -1))
                           for l in leaves], -1)


class _ScanTap:
    """The JAX inference module's ``lax`` with ``scan`` wrapped: every
    body's output carry goes to ``self.carries`` through an ordered
    ``jax.debug.callback``."""

    def __init__(self):
        self.carries = []

    def scan(self, f, init, xs=None, length=None, **kw):
        def body(c, x):
            c2, y = f(c, x)
            jax.debug.callback(lambda c: self.carries.append(jax.tree.map(np.asarray, c)), c2,
                               ordered=True)
            return c2, y

        return jax.lax.scan(body, init, xs, length=length, **kw)

    def __getattr__(self, name):
        return getattr(jax.lax, name)


@pytest.fixture
def tap(monkeypatch):
    t = _ScanTap()
    monkeypatch.setattr(jinf, "lax", t)
    return t


def _near(margins, what):
    """Index of the first step whose decision sits within 1e-3 of its
    threshold (None if none)."""
    for i, m in enumerate(margins):
        m = np.asarray(m)
        if np.isfinite(m).any() and np.abs(m[np.isfinite(m)]).min() < 1e-3:
            print(f"{what}: step {i} decides within 1e-3 of its threshold; compared up to it")
            return i
    return None


# --------------------------------------------------------------- leapfrog
def test_leapfrog_trajectory():
    """One leapfrog trajectory per chain on the GP log-density (5 steps for
    chain 0; chain 1 frozen after 2) against the JAX package's _leapfrog."""
    jcore, tcore, jd, td, p0 = _setup()
    logp = lambda p: -jcore.loss(p, jd)
    grad_fn = jax.grad(logp)
    rng = np.random.default_rng(1)
    flat = Flat(params_from_jax(_np(p0), device="cpu"))
    q0 = flat.ravel(params_from_jax(_np(p0), device="cpu"))
    p_mom = torch.as_tensor(rng.standard_normal(q0.shape), dtype=torch.float32)
    inv_mass = torch.as_tensor(rng.uniform(0.5, 1.5, q0.shape), dtype=torch.float32)
    eps = torch.tensor([0.03, 0.05])
    n_lf = torch.tensor([5, 2])
    vg = lambda v: _value_and_grad(lambda p: -tcore.loss_batched(p, td), flat, v)
    q, p, lp, g = _leapfrog(vg, q0, p_mom, eps, 5, inv_mass, n_lf)
    _, unravel = jax.flatten_util.ravel_pytree(jax.tree.map(lambda t: t[0], p0))
    for c in range(2):
        as_tree = lambda v: unravel(jnp.asarray(v[c].numpy()))
        qj, pj = jinf._leapfrog(grad_fn, as_tree(q0), as_tree(p_mom), float(eps[c]),
                                int(n_lf[c]), as_tree(inv_mass))
        np.testing.assert_allclose(q[c].numpy(), jax.flatten_util.ravel_pytree(qj)[0], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(p[c].numpy(), jax.flatten_util.ravel_pytree(pj)[0], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(float(lp[c]), float(logp(qj)), rtol=1e-5)


# -------------------------------------------------------------------- HMC
def _hmc_draws(keys, q0, n_steps, n_leapfrog):
    """inference.py:177-200's key schedule, per chain."""
    xi, u, n_lf = [], [], []
    for c, key in enumerate(keys):
        k, rows = key, []
        qc = jax.tree.map(lambda t: t[c], q0)
        for _ in range(n_steps):
            k, k_mom, k_acc, k_jit = jax.random.split(k, 4)
            rows.append((np.concatenate([np.asarray(l).ravel() for l in
                                         jax.tree.leaves(jinf._tree_randn_like(k_mom, qc))]),
                         float(jax.random.uniform(k_acc, ())),
                         int(jax.random.randint(k_jit, (), 1, n_leapfrog + 1))))
        xi.append([r[0] for r in rows])
        u.append([r[1] for r in rows])
        n_lf.append([r[2] for r in rows])
    return HMCDraws(torch.as_tensor(np.swapaxes(np.asarray(xi, np.float32), 0, 1)),
                    torch.as_tensor(np.asarray(u, np.float32).T),
                    torch.as_tensor(np.asarray(n_lf).T))


def test_hmc_transitions_dual_averaging_and_mass_switch(tap):
    """Ten HMC transitions of two chains on the GP log-density, with the
    JAX chains' draws: the state, the accept decisions, dual averaging
    (log ε, log ε̄, h̄) and the Welford window, whose metric replaces the
    identity at transition 6 (n_warmup 8: window 2..5) and re-anchors the
    averaging, against the JAX chain kernel step by step."""
    jcore, tcore, jd, td, p0 = _setup(seed=2)
    n_warmup, n_samples, n_lf_max = 8, 2, 4
    kw = dict(n_warmup=n_warmup, n_samples=n_samples, n_leapfrog=n_lf_max, init_step=0.05,
              target_accept=0.8)
    one_chain = jinf._make_hmc_chain(lambda p: -jcore.loss(p, jd), **kw)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    jsteps = []
    for c in range(2):
        tap.carries.clear()
        one_chain(keys[c], jax.tree.map(lambda t: t[c], p0))
        jax.effects_barrier()
        jsteps.append(list(tap.carries))
    draws = _hmc_draws(keys, p0, n_warmup + n_samples, n_lf_max)
    trace = []
    samples, acc = hmc_sample(lambda p: -tcore.loss_batched(p, td), params_from_jax(_np(p0), device="cpu"),
                              n_chains=2, draws=draws, trace=trace, **kw)
    stop = _near([t[5] for t in trace], "hmc") or len(trace)
    assert stop >= 7
    for i in range(stop):
        q, log_eps, log_eps_bar, h_bar, inv_mass, _ = (t.numpy() for t in trace[i])
        for c in range(2):
            jq, da, _, (mean, m2, cnt, jinv) = jsteps[c][i]
            want = np.concatenate([np.asarray(l).ravel() for l in jax.tree.leaves(jq)])
            np.testing.assert_allclose(q[c], want, rtol=1e-4, atol=1e-4, err_msg=f"q step {i}")
            np.testing.assert_allclose([log_eps[c], log_eps_bar[c], h_bar[c]],
                                       [da.log_eps, da.log_eps_bar, da.h_bar], rtol=1e-4, atol=1e-4,
                                       err_msg=f"dual averaging step {i}")
            jinv = np.concatenate([np.asarray(l).ravel() for l in jax.tree.leaves(jinv)])
            np.testing.assert_allclose(inv_mass[c], jinv, rtol=1e-4, atol=1e-4,
                                       err_msg=f"inv_mass step {i}")
    # the metric switched at transition 6 and not before
    assert (trace[5][4] == 1).all() and not (trace[6][4] == 1).all()
    assert samples.log_ls.shape == (n_samples, 2, 2) and acc.shape == (2,)


# ------------------------------------------------------------------ SVI
def test_svi_elbo_gradient_and_steps(tap):
    """The ELBO gradient at the first step (from the JAX Adam state's first
    moment, 0.1·g) and three Adam steps of the mean-field Gaussian, with
    JAX's reparametrization draws, on the GP log-density."""
    jcore, tcore, jd, td, p0 = _setup(R=1, seed=3)
    pj = jax.tree.map(lambda t: t[0], p0)
    n_steps, n_mc, S = 3, 4, 5
    key = jax.random.PRNGKey(5)
    sj, elbo_j = jinf.svi_fit(lambda p: -jcore.loss(p, jd), pj, key, n_steps=n_steps, n_mc=n_mc,
                              n_samples=S)
    jax.effects_barrier()
    carries = list(tap.carries)
    eps, k = [], key
    for _ in range(n_steps):
        k, ke = jax.random.split(k)
        eps.append(np.stack([_flat_normals(kk, pj) for kk in jax.random.split(ke, n_mc)]))
    final = np.stack([_flat_normals(kk, pj) for kk in jax.random.split(k, S)])
    trace = []
    st, elbo = svi_fit(lambda p: -tcore.loss_batched(p, td), params_from_jax(_np(p0), device="cpu"),
                       n_steps=n_steps, n_mc=n_mc, n_samples=S,
                       draws=(torch.as_tensor(np.asarray(eps)), torch.as_tensor(final)), trace=trace)
    flat = lambda t: np.concatenate([np.asarray(l).ravel() for l in jax.tree.leaves(t)])
    (loc1, ls1), (adam1, _), _ = carries[0]
    g_loc, g_ls = flat(adam1.mu[0]) / 0.1, flat(adam1.mu[1]) / 0.1
    np.testing.assert_allclose(trace[0][1].numpy(), g_loc, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(trace[0][2].numpy(), g_ls, rtol=1e-4, atol=1e-4)
    (locf, lsf), _, _ = carries[-1]
    np.testing.assert_allclose(trace[-1][0].numpy(), flat(locf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(trace[-1][1].numpy(), flat(lsf), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Flat(st).ravel(st).numpy(),
                               np.stack([flat(jax.tree.map(lambda t: t[i], sj)) for i in range(S)]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(elbo), float(elbo_j), rtol=1e-4)


# ------------------------------------------------------------------ SMC
def test_smc_systematic_resample_and_mala_move(tap):
    """Two tempering stages of 8 particles on the GP (prior and likelihood
    apart), one MALA move each, with JAX's draws: the ESS falls below half
    at the first stage, so the systematic resampling runs; particles, log
    weights and the evidence per stage against the JAX sampler's."""
    jcore, tcore, jd, td, _ = _setup(seed=4)
    n = 8
    parts0 = jax.vmap(lambda k: jcore.init_params(k, jd))(jax.random.split(jax.random.PRNGKey(9), n))
    # spread the particles, as draws from the prior would be
    rng = np.random.default_rng(4)
    parts0 = parts0._replace(
        log_ls=parts0.log_ls + jnp.asarray(rng.standard_normal(parts0.log_ls.shape), jnp.float32),
        log_noise=jnp.asarray(np.log(1e-2) + rng.standard_normal(n), jnp.float32))
    key = jax.random.PRNGKey(6)
    kw = dict(n_stages=2, n_mala=1, mala_step=0.01)
    pj, logz_j = jinf.smc_sample(jcore.log_prior, lambda p: -jcore.nll(p, jd), parts0, key, **kw)
    jax.effects_barrier()
    stages = list(tap.carries)
    sched, k = [], key
    for _ in range(kw["n_stages"]):
        k, k_res, _ = jax.random.split(k, 3)
        moves = []
        for _ in range(kw["n_mala"]):
            k, kj = jax.random.split(k)
            moves.append((_flat_normals(kj, parts0, n),
                          np.asarray(jax.random.uniform(jax.random.split(kj, 1)[0], (n,)))))
        sched.append((float(jax.random.uniform(k_res, ())), moves))
    trace = []
    pt, logz = smc_sample(tcore.log_prior, lambda p: -tcore.nll_batched(p, td),
                          params_from_jax(_np(parts0), device="cpu"), draws=lambda s: sched[s], trace=trace, **kw)
    assert float(trace[0][3]) < 0.5 * n  # resampled at stage 0
    stop = _near([t[4][0] for t in trace], "smc") or len(trace)
    flat = lambda t: np.concatenate([np.asarray(l).reshape(n, -1) for l in jax.tree.leaves(t)], -1)
    for s in range(stop):
        parts, logw, lz, _, _ = trace[s]
        jparts, jlogw, jlz, _ = stages[s]
        np.testing.assert_allclose(parts.numpy(), flat(jparts), rtol=1e-4, atol=1e-4,
                                   err_msg=f"stage {s}")
        np.testing.assert_allclose(logw.numpy(), jlogw, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(lz), float(jlz), rtol=1e-4, atol=1e-4)
    if stop == len(trace):
        np.testing.assert_allclose(Flat(pt).ravel(pt).numpy(), flat(pj), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(logz), float(logz_j), rtol=1e-4, atol=1e-4)


# --------------------------------------------- whole samplers: Gaussians
def _gauss_logp(mu, sigma):
    return lambda p: -0.5 * ((p["x"] - mu) ** 2).sum(-1) / sigma ** 2


def test_hmc_recovers_gaussian():
    gen = torch.Generator().manual_seed(0)
    init = {"x": torch.randn((8, 3), generator=gen)}
    samples, acc = hmc_sample(_gauss_logp(1.5, 0.7), init, gen, n_chains=8, n_warmup=200,
                              n_samples=150, n_leapfrog=8, init_step=0.2)
    xs = samples["x"].reshape(-1, 3).numpy()
    assert float(acc.mean()) > 0.5
    assert abs(xs.mean() - 1.5) < 0.12
    assert abs(xs.std() - 0.7) < 0.12


def test_svi_recovers_gaussian():
    gen = torch.Generator().manual_seed(1)
    samples, elbo = svi_fit(_gauss_logp(-0.8, 0.5), {"x": torch.zeros((1, 2))}, gen, n_steps=400,
                            n_samples=400, lr=0.05)
    xs = samples["x"].numpy()
    assert abs(xs.mean() - (-0.8)) < 0.15
    assert abs(xs.std() - 0.5) < 0.15
    assert np.isfinite(float(elbo))


def test_smc_recovers_gaussian():
    gen = torch.Generator().manual_seed(2)
    init = {"x": 3.0 * torch.randn((256, 2), generator=gen)}
    parts, logZ = smc_sample(lambda p: -0.5 * (p["x"] ** 2).sum(-1) / 3.0 ** 2,
                             lambda p: -0.5 * ((p["x"] - 1.0) ** 2).sum(-1) / 0.5 ** 2, init, gen,
                             n_stages=24, n_mala=3, mala_step=0.05)
    # posterior: precision 1/9 + 1/.25 → mean ≈ 0.973, std ≈ 0.494
    assert abs(parts["x"].numpy().mean() - 0.973) < 0.2
    assert np.isfinite(float(logZ))


# ---------------------------------------------------------------- GP level
def _gp_problem():
    from hebo_tpu import DesignSpace as JSpace
    from hebo_tpu_torch import DesignSpace

    spec = [{"name": "x0", "type": "num", "lb": -1, "ub": 1},
            {"name": "x1", "type": "num", "lb": -1, "ub": 1}]
    space = DesignSpace(spec)
    X = space.transform(space.sample(20, seed=0))
    y = np.sin(3 * X[:, :1]) + 0.5 * X[:, 1:]
    Xq = space.transform(space.sample(12, seed=1))
    return JSpace(spec), space, X, y, Xq


@pytest.fixture(scope="module")
def jax_map_gp():
    from hebo_tpu.models import get_model as jget

    jspace, _, X, y, Xq = _gp_problem()
    gp = jget("gp", jspace, num_out=1, num_epochs=20).fit(X, y)
    return gp.predict(Xq)


@pytest.mark.parametrize("conf", [{"inference": "hmc"}, {"inference": "svi"},
                                  {"inference": "smc"}, {"optimizer": "slice"}])
def test_gp_with_posterior_inference(conf, jax_map_gp):
    """GP(inference=m) and optimizer="slice": an ensemble of 4 distinct
    samples, finite predictions, ``ok`` caches, and the posterior mean at
    held-out points within ±2σ of the JAX GP's MAP fit on the same data."""
    from hebo_tpu_torch.models import get_model

    _, space, X, y, Xq = _gp_problem()
    gp = get_model("gp", space, device="cpu", num_epochs=20, n_ensemble=4, n_chains=2,
                   n_warmup=16, n_particles=16, **conf).fit(X, y)
    mu, var = gp.predict(X)
    assert mu.shape == (20, 1) and np.isfinite(mu).all() and (var > 0).all()
    assert gp.samples.log_ls.shape == (4, 2) and np.ptp(gp.samples.log_ls.numpy()) > 1e-5
    assert bool(gp.caches.ok.all())
    if conf.get("inference") == "hmc":
        assert gp.accept_rate.shape == (2,)
    mu_j, var_j = jax_map_gp
    mu_q, _ = gp.predict(Xq)
    assert (np.abs(mu_q - mu_j) <= 2 * np.sqrt(var_j)).all()


def test_gp_sampler_above_max_cholesky_size():
    """Above max_cholesky_size the sampler runs on the fitted subsample and
    the CG cache holds all the data (gp.py:1055-1073)."""
    from hebo_tpu_torch.models import get_model

    _, space, X, y, Xq = _gp_problem()
    X2 = np.concatenate([X, space.transform(space.sample(20, seed=5))])
    y2 = np.sin(3 * X2[:, :1]) + 0.5 * X2[:, 1:]
    gp = get_model("gp", space, device="cpu", num_epochs=10, n_ensemble=2, inference="svi",
                   max_cholesky_size=16, cg_rank=8, cg_iters=48).fit(X2, y2)
    assert gp.fit_data.X.shape[0] == 16 and gp.data.X.shape[0] == 64
    assert gp.caches.Kt.shape == (2, 64, 64) and bool(gp.caches.ok.all())
    mu, var = gp.predict(Xq)
    assert np.isfinite(mu).all() and (var > 0).all()


# ---------------------------------------------------------- Thompson draws
@pytest.mark.parametrize("route", ["dense", "cg"])
def test_joint_sample_scaled_with_fed_z(route):
    """joint_sample_scaled against the JAX package's with its z: dense (the
    cached W = L⁻¹) and CG (bucket 32 above max_cholesky_size 16)."""
    n_pad, kw = (N_PAD, {}) if route == "dense" else (32, dict(max_cholesky_size=16, cg_rank=8,
                                                               cg_iters=64))
    args = dict(numeric_dims=(0, 1), cat_dims=(), num_categories=(), **kw)
    jcore, tcore = JCore(**args), GPCore(**args)
    rng = np.random.default_rng(8)
    X = rng.uniform(-1, 2, (20 if route == "cg" else N_OBS, 2))
    jd = _make_data(X, np.sin(3 * X[:, :1]) + X[:, 1:] ** 2, (0, 1), n_pad)
    td = data_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()}, device="cpu")
    pj = jax.tree.map(lambda t: t[0], jax.vmap(lambda k: jcore.init_params(k, jd))(
        jax.random.split(jax.random.PRNGKey(1), 1)))
    pj = pj._replace(log_noise=jnp.asarray(np.log(0.05), jnp.float32))
    cj = jcore.posterior_cache(pj, jd)
    pt = params_from_jax(_np(pj), device="cpu")
    ct = tcore.posterior_cache_batched(pt, td)
    Xs = rng.uniform(-1, 2, (9, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    dj = np.asarray(jcore.joint_sample_scaled(key, pj, cj, jd, jnp.asarray(Xs), 6))
    z = np.asarray(jax.random.normal(key, (6, 9), jnp.float32))
    d = tcore.joint_sample_scaled(pt, ct, td, torch.as_tensor(Xs), 6, z=torch.as_tensor(z))
    assert (ct.Kt is not None) == (route == "cg")
    np.testing.assert_allclose(d.numpy(), dj, rtol=1e-4, atol=1e-4)


def test_sample_f_and_joint_sample_pure():
    """GP.sample_f: (n_samples, n, 1) draws in the raw-y frame, the same at
    one seed, whose mean tends to predict's; joint_sample_pure: one draw
    (P, 1) from a uniformly picked sample."""
    from hebo_tpu_torch.models import get_model

    _, space, X, y, Xq = _gp_problem()
    gp = get_model("gp", space, device="cpu", num_epochs=10).fit(X, y)
    assert gp.support_ts
    f = gp.sample_f(n_samples=400, seed=0)
    d = f(Xq)
    assert d.shape == (400, 12, 1) and np.isfinite(d).all()
    np.testing.assert_array_equal(d, f(Xq))
    mu, var = (np.asarray(a) for a in gp.predict(Xq))
    ok = np.abs(d.mean(0) - mu) <= 4 * np.sqrt(var) / np.sqrt(400)
    assert ok.mean() >= 0.9
    one = gp.joint_sample_pure(gp.state, torch.Generator().manual_seed(0),
                               torch.as_tensor(Xq, dtype=torch.float32))
    assert one.shape == (12, 1) and torch.isfinite(one).all()
