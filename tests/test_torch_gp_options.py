"""hebo_tpu_torch's GP options against hebo_tpu on CPU: the other stationary
kernels, the input warp, heteroscedastic noise, the slice optimizer, the
``gpy_wgp`` / ``gpy_mlp`` models and HEBO's routing of each.

Both packages get the same numpy data and hyperparameters (carried over with
``params_from_jax`` / ``data_from_jax``); the JAX side's random draws are fed
to the port.  Tolerances (float32 on both sides):
* kernel values and gradients in (x, ℓ): rtol 1e-5, atol 1e-6;
* warped features, heteroscedastic noise: 1e-6;
* the loss: rtol 1e-4; its gradient rtol 1e-4 with atol 1e-4 (the batched
  NLL's backward goes through S⁻¹ = WᵀW, the JAX package's unbatched one
  through a triangular solve);
* 4-step pSGLD and Adam fits with JAX's draws: 1e-4 absolute on the
  parameters and the loss.
"""

import numpy as np
import pytest
import torch

import jax
import jax.flatten_util
import jax.numpy as jnp

from hebo_tpu.models.gp import kernels as jk
from hebo_tpu.models.gp.gp import GPCore as JCore
from hebo_tpu.models.gp.gp import _make_data
from hebo_tpu.models.gp.inference import slice_sample as jslice
from hebo_tpu_torch.models.gp import GPCore, data_from_jax, kernels as tk, params_from_jax
from hebo_tpu_torch.models.gp.gp import GPParams
from hebo_tpu_torch.models.gp.inference import slice_sample
from hebo_tpu_torch.models.gp.tree import Flat, tree_leaves

N_OBS, N_PAD = 13, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
KERNELS = ["matern12", "matern32", "matern52", "rbf", "mlp"]


def _np(p):
    return {k: np.asarray(v) for k, v in p._asdict().items() if v is not None}


def _cores(**kw):
    args = dict(numeric_dims=(0, 1, 2), cat_dims=(3,), num_categories=(3,), n_steps=4, **kw)
    return JCore(**args), GPCore(**args)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = np.concatenate([rng.uniform(-1, 2, (N_OBS, 3)), rng.integers(0, 3, (N_OBS, 1))], 1)
    y = (np.sin(3 * X[:, :1]) + X[:, 1:2] ** 2 + 0.3 * X[:, 3:4]).astype(np.float32)
    jd = _make_data(X, y, (0, 1, 2), N_PAD)
    return jd, data_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()}, device="cpu")


def _jax_p0(jcore, jd, R=2, seed=0, perturb=0.3):
    """R initial parameter sets, with the warp and noise weights moved off
    their zero start so that they matter."""
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    p = jax.vmap(lambda k: jcore.init_params(k, jd))(keys)
    rng = np.random.default_rng(seed + 100)
    upd = dict(log_wa=jnp.asarray(perturb * rng.standard_normal(p.log_wa.shape), jnp.float32),
               log_wb=jnp.asarray(perturb * rng.standard_normal(p.log_wb.shape), jnp.float32))
    if p.noise_w is not None:
        upd["noise_w"] = jnp.asarray(perturb * rng.standard_normal(p.noise_w.shape), jnp.float32)
    return p._replace(**upd)


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("name", KERNELS)
def test_stationary_kernels_values_and_gradients(name):
    rng = np.random.default_rng(1)
    x1 = rng.standard_normal((7, 3)).astype(np.float32)
    x2 = rng.standard_normal((5, 3)).astype(np.float32)
    ls = rng.uniform(0.4, 2.0, 3).astype(np.float32)
    G = rng.standard_normal((7, 5)).astype(np.float32)
    f = lambda a, b, l: jnp.sum(jk.MATERN_FNS[name](a, b, l) * G)
    Kj = np.asarray(jk.MATERN_FNS[name](x1, x2, ls))
    gj = jax.grad(f, (0, 1, 2))(x1, x2, ls)
    ts = [torch.tensor(a, requires_grad=True) for a in (x1, x2, ls)]
    K = tk.MATERN_FNS[name](*ts)
    np.testing.assert_allclose(K.detach().numpy(), Kj, rtol=1e-5, atol=1e-6)
    gt = torch.autograd.grad((K * torch.as_tensor(G)).sum(), ts)
    for what, a, b in zip(("x1", "x2", "ls"), gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6, err_msg=what)
    # batched form: a leading axis on the points and the lengthscales
    Kb = tk.MATERN_FNS[name](torch.as_tensor(np.stack([x1, 2 * x1])),
                             torch.as_tensor(np.stack([x2, x2])), torch.as_tensor(np.stack([ls, ls])))
    np.testing.assert_allclose(Kb[1].numpy(), np.asarray(jk.MATERN_FNS[name](2 * x1, x2, ls)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["matern12", "matern52", "rbf", "mlp"])
def test_self_gram_gradients_with_coincident_points(name):
    """At d = 0 (a self-Gram's diagonal, repeated rows) the +1e-16 inside
    the square root and the floor's tie gradient give the JAX package's
    gradient."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 2)).astype(np.float32)
    x[4] = x[1]
    ls = np.asarray([0.7, 1.3], np.float32)
    G = rng.standard_normal((6, 6)).astype(np.float32)
    gj = jax.grad(lambda a, l: jnp.sum(jk.MATERN_FNS[name](a, a, l) * G), (0, 1))(x, ls)
    xt, lt = torch.tensor(x, requires_grad=True), torch.tensor(ls, requires_grad=True)
    gt = torch.autograd.grad((tk.MATERN_FNS[name](xt, xt, lt) * torch.as_tensor(G)).sum(), (xt, lt))
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- features, noise
def test_warped_features_and_heteroscedastic_noise():
    jcore, tcore = _cores(input_warp=True, heteroscedastic=True)
    jd, td = _data()
    pj = _jax_p0(jcore, jd, perturb=0.5)
    pt = params_from_jax(_np(pj), device="cpu")
    assert pt.noise_w.shape == (2, tcore.n_feat_dims + 1)
    fj = np.asarray(jax.vmap(lambda p: jcore.features(p, jd.X, jd))(pj))
    np.testing.assert_allclose(tcore.features(pt, td.X, td).numpy(), fj, rtol=1e-6, atol=1e-6)
    nj = np.asarray(jax.vmap(lambda p: jcore.noise_diag(p, jd.X, jd))(pj))
    np.testing.assert_allclose(tcore.noise_diag(pt, td.X, td).numpy(), nj, rtol=1e-6, atol=1e-6)
    assert np.ptp(nj[0]) > 1e-3  # the noise varies over the points
    lpj = np.asarray(jax.vmap(jcore.log_prior)(pj))
    np.testing.assert_allclose(tcore.log_prior(pt).numpy(), lpj, rtol=1e-6, atol=1e-6)


def test_init_params_noise_w_and_params_from_jax():
    """noise_w starts at zero with heteroscedastic noise and is absent
    otherwise; params_from_jax carries it, and its None.  (Without the input
    warp: the median-distance init keeps the self-distances that round to
    more than 1e-12, gp.py:448-450, so with the warp's 1e-6 clips its median
    can take the next order statistic in either package; the warped
    features themselves are held above.)"""
    for het in (False, True):
        jcore, tcore = _cores(heteroscedastic=het)
        jd, td = _data()
        keys = jax.random.split(jax.random.PRNGKey(0), 2)
        p0j = jax.vmap(lambda k: jcore.init_params(k, jd))(keys)
        z_emb, z_ls = [], []
        for k in keys:
            ke, kl = jax.random.split(k)
            z_emb.append(np.asarray(jax.random.normal(ke, (jcore.total_cats, jcore.emb_dim))))
            z_ls.append(np.asarray(jax.random.normal(kl, (jcore.d_feat,))))
        p0 = tcore.init_params(td, 2, draws=(np.stack(z_emb), np.stack(z_ls)))
        assert (p0.noise_w is None) == (not het) == (p0j.noise_w is None)
        conv = params_from_jax({k: (None if v is None else np.asarray(v))
                                for k, v in p0j._asdict().items()}, device="cpu")
        assert (conv.noise_w is None) == (not het)
        for k, v in _np(p0j).items():
            np.testing.assert_allclose(getattr(p0, k).numpy(), v, rtol=1e-5, atol=1e-6, err_msg=k)
            np.testing.assert_array_equal(getattr(conv, k).numpy(), v, err_msg=k)


# -------------------------------------------------------------------- loss
def _f64(jd, td, pj, pt):
    """The data and parameters of both packages in float64."""
    cast = lambda t: jnp.asarray(np.asarray(t), jnp.float64 if np.asarray(t).dtype == np.float32
                                 else np.asarray(t).dtype)
    tcast = lambda t: t.double() if t is not None and t.dtype == torch.float32 else t
    return (jax.tree.map(cast, jd), jax.tree.map(cast, pj), type(td)(*map(tcast, td)),
            type(pt)(*map(tcast, pt)))


@pytest.mark.parametrize("kernel,warp,het", [(k, False, False) for k in KERNELS]
                         + [("matern32", True, True), ("rbf", True, False), ("mlp", False, True)])
def test_loss_and_gradient_with_options(kernel, warp, het):
    """The batched loss and its gradient against ``jax.vmap(core.loss)`` and
    ``jax.grad``.  Matérn-1/2's gradient is held in float64 on both sides:
    at the train Gram's diagonal (d = 0) ∂√(d² + 1e-16)/∂d² is 5e7, which
    turns the float32 rounding of the expansion form's two reductions into
    an O(1) error in ∂/∂ log ℓ in either package (ROADMAP §3)."""
    jcore, tcore = _cores(kernel=kernel, input_warp=warp, heteroscedastic=het)
    jd, td = _data(seed=3)
    pj = _jax_p0(jcore, jd, seed=1)
    pt = params_from_jax(_np(pj), device="cpu")
    lj = np.asarray(jax.vmap(lambda p: jcore.loss(p, jd))(pj))
    np.testing.assert_allclose(tcore.loss_batched(pt, td).numpy(), lj, rtol=1e-4)
    if kernel == "matern12":
        with jax.enable_x64():
            jd, pj, td, pt = _f64(jd, td, pj, pt)
            gj = jax.jit(jax.grad(lambda P, d: jnp.sum(jax.vmap(lambda p: jcore.loss(p, d))(P))))(
                pj, jd)
    else:
        gj = jax.grad(lambda P: jnp.sum(jax.vmap(lambda p: jcore.loss(p, jd))(P)))(pj)
    leaves = [None if t is None else t.requires_grad_(True) for t in pt]
    loss = tcore.loss_batched(GPParams(*leaves), td)
    live = [t for t in leaves if t is not None]
    grads = torch.autograd.grad(loss.sum(), live, allow_unused=True)
    names = [n for n, t in zip(GPParams._fields, leaves) if t is not None]
    for name, g, t in zip(names, grads, live):
        want = np.asarray(getattr(gj, name))
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=name)


# --------------------------------------------------------------------- fits
def _psgld_noise(key, p0, n_steps):
    """gp.py:630-641's key schedule: one normal per leaf (None skipped) per step."""
    shapes = [t.shape for t in jax.tree.leaves(p0)]
    noise, k = [], key
    for _ in range(n_steps):
        k, ksub = jax.random.split(k)
        ks = jax.random.split(ksub, len(shapes))
        noise.append([np.asarray(jax.random.normal(kk, s, jnp.float32)) for kk, s in zip(ks, shapes)])
    return noise


@pytest.mark.parametrize("model,optimizer", [("gpy_wgp", "psgld"), ("gpy_mlp", "psgld"),
                                             ("het", "psgld"), ("gpy_wgp", "adam"),
                                             ("het", "adam")])
def test_fits_of_the_option_models(model, optimizer):
    """4 steps of pSGLD (JAX's draws fed) or Adam on the stacked restarts of
    gpy_wgp (input warp, 4 restarts), gpy_mlp (the MLP kernel) and a
    heteroscedastic gp."""
    kw = {"gpy_wgp": dict(input_warp=True), "gpy_mlp": dict(kernel="mlp"),
          "het": dict(heteroscedastic=True)}[model]
    R = 4 if model == "gpy_wgp" else 2
    jcore, tcore = _cores(optimizer=optimizer, **kw)
    jd, td = _data(seed=4)
    p0j = _jax_p0(jcore, jd, R=R, seed=2, perturb=0.1)
    key = jax.random.PRNGKey(11)
    pfj, lossj, sj = jcore.fit_from_batched(key, p0j, jd)
    noise = _psgld_noise(key, p0j, jcore.n_steps)
    pf, loss, s = tcore.fit_from_batched(params_from_jax(_np(p0j), device="cpu"), td, noise=lambda i: noise[i])
    for name, want in _np(pfj).items():
        np.testing.assert_allclose(getattr(pf, name).numpy(), want, rtol=0, atol=1e-4, err_msg=name)
    for name, want in _np(sj).items():
        np.testing.assert_allclose(getattr(s, name).numpy(), want, rtol=0, atol=1e-4, err_msg=name)
    np.testing.assert_allclose(loss.numpy(), np.asarray(lossj), rtol=1e-4, atol=1e-4)


def _slice_uniforms(keys, dim, sweeps):
    """inference.py:409-444's key schedule per chain: (sweeps, dim, 18, R)."""
    out = np.zeros((sweeps, dim, 18, len(keys)), np.float32)
    for r, k in enumerate(keys):
        for s in range(sweeps):
            for i in range(dim):
                k, k1, k2, k3 = jax.random.split(k, 4)
                out[s, i, 0, r] = jax.random.uniform(k1, ())
                out[s, i, 1, r] = jax.random.uniform(k2, ())
                out[s, i, 2:, r] = [jax.random.uniform(kk, ()) for kk in jax.random.split(k3, 16)]
    return out


def test_slice_step_out_and_shrink_with_fed_uniforms():
    """One sweep of the slice sampler over every coordinate of two restarts
    of the warped GP's loss, against the JAX sampler run per restart with
    its own key; the JAX side's log-densities come out through
    ``jax.debug.callback``.  Every evaluation must fall on the same side of
    the slice height in both packages; a coordinate whose decisions sit
    within 1e-3 of the height ends the comparison there."""
    args = dict(numeric_dims=(0, 1), cat_dims=(), num_categories=(), input_warp=True)
    jcore, tcore = JCore(**args), GPCore(**args)
    rng = np.random.default_rng(5)
    X = rng.uniform(-1, 2, (N_OBS, 2))
    jd = _make_data(X, np.sin(3 * X[:, :1]) + X[:, 1:] ** 2, (0, 1), N_PAD)
    td = data_from_jax({k: np.asarray(v) for k, v in jd._asdict().items()}, device="cpu")
    p0j = _jax_p0(jcore, jd, R=2, seed=3, perturb=0.1)
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    want, jvals = [], []
    for r in range(2):
        pr = jax.tree.map(lambda t: t[r], p0j)
        vals = []

        def jlogp(p):
            v = -jcore.loss(p, jd)
            jax.debug.callback(lambda x: vals.append(float(x)), v, ordered=True)
            return v

        sj = jslice(jlogp, pr, keys[r], n_samples=1, n_burnin=0, thinning=1)
        jax.effects_barrier()
        want.append(np.asarray(jax.flatten_util.ravel_pytree(jax.tree.map(lambda t: t[0], sj))[0]))
        jvals.append(vals)
    want, jvals = np.stack(want), np.asarray(jvals)
    dim = want.shape[1]
    uni = _slice_uniforms(keys, dim, 1)
    evals = []

    def logp(p):
        v = -tcore.loss_batched(p, td)
        evals.append(v.numpy())
        return v

    st = slice_sample(logp, params_from_jax(_np(p0j), device="cpu"), n_samples=1, n_burnin=0, thinning=1,
                      uniforms=torch.as_tensor(uni))
    got = Flat(st, n_lead=2).ravel(st)[0].numpy()
    # per coordinate: 1 + 2·8 + 16 evaluations; the first sets the height
    per = 1 + 16 + 16
    tvals = np.stack(evals, 1)
    assert tvals.shape == jvals.shape == (2, per * dim)
    stop = dim
    for i in range(dim):
        t, j = tvals[:, per * i: per * (i + 1)], jvals[:, per * i: per * (i + 1)]
        height = t[:, :1] + np.log(uni[0, i, 0][:, None] + 1e-12)
        if np.abs(t[:, 1:] - height).min() < 1e-3:
            print(f"slice: coordinate {i} decides within 1e-3 of its height; compared up to it")
            stop = i
            break
        np.testing.assert_array_equal(t[:, 1:] > height, j[:, 1:] > height)
    assert stop > dim // 2
    np.testing.assert_allclose(got[:, :stop], want[:, :stop], rtol=1e-4, atol=1e-4)


def test_slice_fit_through_the_gp_core():
    """``optimizer="slice"``: the stacked restarts' samples (S, R, ...) from
    the 20 burn-in sweeps, then every second; the last sample as the final
    parameters, with its loss; each restart its own chain."""
    tcore = GPCore(numeric_dims=(0,), cat_dims=(), num_categories=(), optimizer="slice",
                   n_ensemble=2)
    rng = np.random.default_rng(0)
    from hebo_tpu_torch.models.gp.gp import make_data
    X = rng.uniform(-1, 1, (6, 1))
    td = make_data(X, np.sin(3 * X), (0,), 8, "cpu")
    p0 = tcore.init_params(td, 2, torch.Generator().manual_seed(0))
    pf, loss, s = tcore.fit_from_batched(p0, td, torch.Generator().manual_seed(1))
    assert s.log_ls.shape == (2, 2, 1) and pf.log_ls.shape == (2, 1) and s.noise_w is None
    for a, b in zip(tree_leaves(pf), tree_leaves(s)):
        assert torch.equal(a, b[-1])
    assert torch.equal(loss, tcore.loss_batched(pf, td))
    assert torch.isfinite(loss).all()
    flat = Flat(s, n_lead=2).ravel(s)
    assert (flat[0] != flat[1]).all() and (flat[:, 0] != flat[:, 1]).all()


# ------------------------------------------------------------ HEBO routing
def _space():
    from hebo_tpu_torch import DesignSpace
    return DesignSpace([{"name": "x0", "type": "num", "lb": -2, "ub": 2},
                        {"name": "x1", "type": "num", "lb": -2, "ub": 2},
                        {"name": "c", "type": "cat", "categories": ["a", "b", "c"]}])


def _f(df):
    return ((df[["x0", "x1"]].values ** 2).sum(1) + (df["c"] == "b")).values.reshape(-1, 1)


def _routes(opt):
    routes = []
    for name in ("_fused_suggest", "_generic_suggest"):
        orig = getattr(opt, name)
        setattr(opt, name, lambda *a, _o=orig, _n=name, **k: (routes.append(_n[1:-8]), _o(*a, **k))[1])
    return routes


@pytest.mark.parametrize("model_name,conf,route", [
    ("gp", {}, "fused"),
    ("gp", {"input_warp": True, "heteroscedastic": True}, "fused"),
    ("gp", {"kernel": "matern52"}, "fused"),
    ("gp", {"kernel": "mlp", "optimizer": "adam"}, "fused"),
    ("gpy_wgp", {}, "generic"),
    ("gpy_mlp", {}, "generic"),
    ("gp", {"inference": "hmc", "n_warmup": 8}, "generic"),
    ("gp", {"max_cholesky_size": 4}, "generic"),
])
def test_hebo_loop_and_route_of_each_option(model_name, conf, route):
    """HEBO's rule (hebo.py:132-140): a plain GP with inference 'map' up to
    max_cholesky_size takes the fused program, whatever its kernel, warp or
    noise; the subclasses, the samplers and large buckets the generic
    route.  Each runs suggest/observe and gives valid batches."""
    from hebo_tpu_torch import HEBO

    space = _space()
    opt = HEBO(space, model_name=model_name, device="cpu", pop=16, iters=4,
               model_config={"num_epochs": 6, **conf})
    routes = _routes(opt)
    for _ in range(3):
        rec = opt.suggest(4)
        X = space.transform(rec)
        assert len(rec) == 4 and np.isfinite(X).all()
        assert (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
        opt.observe(rec, _f(rec))
    assert routes == [route, route]
    assert type(opt.model).__name__ == {"gpy_wgp": "WarpedGP", "gpy_mlp": "MLPKernelGP"}.get(
        model_name, "GP")
    assert np.isfinite(opt.best_y)
    if conf.get("heteroscedastic"):
        assert opt.model.params.noise_w.shape == (1, opt.model.core.n_feat_dims + 1)


def test_hebo_model_defaults_and_unported_models():
    """gpy_wgp is the warped GP with 4 restarts, gpy_mlp the MLP kernel;
    HEBO takes every registered model (rf among them), and a GP builds on a
    device mesh (a gloo group of one rank here), its chain and particle
    counts rounded up to the mesh size."""
    import torch.distributed as dist

    from hebo_tpu_torch import HEBO
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.parallel import make_mesh

    space = _space()
    wgp = get_model("gpy_wgp", space, device="cpu")
    mlp = get_model("gpy_mlp", space, device="cpu")
    assert wgp.core.input_warp and wgp.n_restarts == 4 and wgp.core.kernel_name == "matern32"
    assert mlp.core.kernel_name == "mlp" and not mlp.core.input_warp
    assert HEBO(space, model_name="rf", device="cpu").model_name == "rf"
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        gp = get_model("gp", space, device="cpu", mesh=make_mesh(device="cpu"), n_chains=3)
        assert gp.core.mesh is gp.mesh and gp.n_chains == 3 and gp.core._use_block_sharded(4096)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="unknown kernel"):
        get_model("gp", space, device="cpu", kernel="periodic")


def test_hebo_slice_optimizer_on_the_fused_program():
    """``optimizer="slice"`` on a plain GP stays on the fused program (as the
    JAX package's rule has it), its uniforms drawn with the suggest's other
    draws; a 1-D space keeps the 20 burn-in sweeps short."""
    from hebo_tpu_torch import DesignSpace, HEBO

    space = DesignSpace([{"name": "x0", "type": "num", "lb": -2, "ub": 2}])
    opt = HEBO(space, device="cpu", pop=12, iters=3, model_config={"optimizer": "slice"})
    routes = _routes(opt)
    rec = opt.suggest(2)
    opt.observe(rec, rec[["x0"]].values ** 2)
    rec = opt.suggest(2)
    assert routes == ["fused"] and len(rec) == 2 and np.isfinite(space.transform(rec)).all()
    dr = opt._draws(torch.device("cpu"))
    assert dr.fit_uni.shape == (22, 6, 18, 2)  # log_ls, sc, noise, mean, wa, wb
    assert opt.model.samples.log_ls.shape == (1, 1) and bool(opt.model.caches.ok.all())
