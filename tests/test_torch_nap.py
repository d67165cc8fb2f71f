"""The NAP transformer surrogate in hebo_tpu_torch (``meta/nap.py``) against
hebo_tpu on CPU.

The same numpy-seeded inputs go through both packages, with the JAX
package's random draws (its PRNG key schedule, replayed) fed to the port.
Tolerances (float32 both sides, relative to the largest |value|):
* ``TransformerNP``'s forward on carried-across flax params, numeric and
  mixed: 1e-5;
* ``sample_gp_tasks`` with fed draws: 1e-5;
* three ``meta_train_np`` steps from the JAX package's init with its task
  draws and context sizes: the losses, the params and the trained
  forward at 1e-4; the attention's key-projection biases, whose gradient
  is exactly zero, within Adam's reach of their start in both packages;
* ``NAPSurrogate.predict`` and ``predict_pure`` on a carried-across state:
  1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.meta import nap as jnap
from hebo_tpu_torch import HEBO
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.meta import nap as tnap
from hebo_tpu_torch.models.gp import model_from_jax

NUM = [{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 2.0} for i in range(2)]
MIXED = [{"name": "x0", "type": "num", "lb": -1.0, "ub": 1.0},
         {"name": "c0", "type": "cat", "categories": ["a", "b", "c"]},
         {"name": "x1", "type": "num", "lb": 0.0, "ub": 3.0}]
KINDS = {"numeric": dict(dim_x=3, cat_dims=(), num_categories=()),
         "mixed": dict(dim_x=3, cat_dims=(1,), num_categories=(3,))}
SMALL = {"meta_steps": 2, "d_model": 16, "n_layers": 1}
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


def _close(a, b, rtol):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-30))


def _jax_draws(key, batch, n_points, dim_x, num_categories=()):
    """The random numbers of ``hebo_tpu.meta.nap.sample_gp_tasks(key, ...)``."""
    kx, kl, kf, kn, kc = jax.random.split(key, 5)
    codes = []
    for c in num_categories:
        kc, kj = jax.random.split(kc)
        codes.append(np.asarray(jax.random.randint(kj, (batch, n_points), 0, c)))
    return tnap.TaskDraws(
        X=T(np.array(jax.random.uniform(kx, (batch, n_points, dim_x), jnp.float32, -1.0, 1.0))),
        codes=T(np.stack(codes, -1)) if codes else None,
        log_ls=T(np.array(jax.random.uniform(kl, (batch, 1, 1, 1), jnp.float32, -1.5, 0.5))),
        z=T(np.array(jax.random.normal(kf, (batch, n_points), jnp.float32))),
        eps=T(np.array(jax.random.normal(kn, (batch, n_points, 1), jnp.float32))))


def _models(kind, d_model=16, n_layers=2):
    kw = KINDS[kind]
    jm = jnap.TransformerNP(d_model=d_model, n_layers=n_layers, **kw)
    tm = tnap.TransformerNP(d_model=d_model, n_layers=n_layers,
                            generator=torch.Generator().manual_seed(0), **kw)
    return jm, tm


def _inputs(kind, seed=0, B=2, Nc=9, Nq=5):
    kw = KINDS[kind]
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (B, Nc + Nq, kw["dim_x"])).astype(np.float32)
    for j, c in zip(kw["cat_dims"], kw["num_categories"]):
        X[:, :, j] = rng.integers(0, c, (B, Nc + Nq))
    yc = rng.standard_normal((B, Nc, 1)).astype(np.float32)
    mask = np.arange(Nc)[None, :] < np.asarray([[Nc], [5]])[:B]
    return X[:, :Nc], yc, X[:, Nc:], mask


@pytest.mark.parametrize("kind", list(KINDS))
def test_nap_from_flax_uses_every_leaf(kind):
    jm, tm = _models(kind)
    Xc, yc, Xq, mask = _inputs(kind)
    p = jm.init(jax.random.PRNGKey(1), Xc, yc, Xq, mask)
    sd = tnap.nap_from_flax(p, tm)
    assert set(sd) == {k for k, _ in tm.named_parameters()}
    assert len(sd) == len(jax.tree_util.tree_leaves(p))
    extra = {"params": dict(p["params"], Dense_99={"kernel": np.zeros((16, 1))})}
    with pytest.raises(ValueError, match="not used"):
        tnap.nap_from_flax(extra, tm)
    missing = {"params": {k: v for k, v in p["params"].items() if k != "LayerNorm_1"}}
    with pytest.raises(KeyError):
        tnap.nap_from_flax(missing, tm)


@pytest.mark.parametrize("kind", list(KINDS))
def test_transformer_forward_on_carried_params(kind):
    jm, tm = _models(kind)
    Xc, yc, Xq, mask = _inputs(kind)
    p = jm.init(jax.random.PRNGKey(2), Xc, yc, Xq, mask)
    # widen the init a little so that every layer's output matters
    p = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(3), a.shape), p)
    mu, ls = jm.apply(p, Xc, yc, Xq, mask)
    tm.load_state_dict(tnap.nap_from_flax(p, tm))
    with torch.no_grad():
        tmu, tls = tm(T(Xc), T(yc), T(Xq), T(mask))
    _close(tmu.numpy(), mu, 1e-5)
    _close(tls.numpy(), ls, 1e-5)


@pytest.mark.parametrize("kind", list(KINDS))
def test_sample_gp_tasks_with_fed_draws(kind):
    kw = KINDS[kind]
    key = jax.random.PRNGKey(7)
    X, y = jnap.sample_gp_tasks(key, 3, 16, kw["dim_x"], cat_dims=kw["cat_dims"],
                                num_categories=kw["num_categories"])
    d = _jax_draws(key, 3, 16, kw["dim_x"], kw["num_categories"])
    tX, ty = tnap.sample_gp_tasks(3, 16, kw["dim_x"], cat_dims=kw["cat_dims"],
                                  num_categories=kw["num_categories"], draws=d)
    np.testing.assert_array_equal(tX.numpy(), np.asarray(X))
    _close(ty.numpy(), y, 1e-5)


def test_meta_train_steps_with_fed_draws():
    """Three Adam steps from the JAX package's init with its tasks and
    context sizes, on the mixed inputs (numeric columns and a categorical
    embedding): the same losses and params at 1e-4."""
    kind = "mixed"
    kw = KINDS[kind]
    B, n, min_ctx, steps = 4, 12, 4, 3
    jm, tm = _models(kind)
    key = jax.random.PRNGKey(0)
    params, losses = jnap.meta_train_np(jm, key, n_steps=steps, batch=B, n_points=n, min_ctx=min_ctx)
    k0, k = jax.random.split(key)  # meta_train_np's key schedule
    Xd, yd = jnap.sample_gp_tasks(k0, 1, n, kw["dim_x"], cat_dims=kw["cat_dims"],
                                  num_categories=kw["num_categories"])
    p0 = jm.init(k0, Xd[:, :min_ctx], yd[:, :min_ctx], Xd[:, min_ctx:], jnp.ones((1, min_ctx), bool))
    fed = []
    for _ in range(steps):
        k, ks = jax.random.split(k)
        k1, k2 = jax.random.split(ks)
        fed.append((_jax_draws(k1, B, n, kw["dim_x"], kw["num_categories"]),
                    int(jax.random.randint(k2, (), min_ctx, n - 4))))
    tm.load_state_dict(tnap.nap_from_flax(p0, tm))
    tparams, tlosses = tnap.meta_train_np(tm, n_steps=steps, batch=B, n_points=n, min_ctx=min_ctx,
                                          steps=fed)
    _close(tlosses, losses, 1e-4)
    want = tnap.nap_from_flax(params, tm)
    for name, v in want.items():
        if name.endswith("attn.key.bias"):
            # softmax is shift-invariant per query, so q·b_k adds the same to
            # every logit of a row: this bias's gradient is exactly 0 and
            # only rounding moves it, by up to lr per Adam step, in each
            # package.  It cannot change an output (held below).
            start = dict(tm.named_parameters())[name].detach().numpy()
            for got in (tparams[name].numpy(), v.numpy()):
                assert np.abs(got - start).max() <= steps * 1e-3 * (1 + 1e-3)
            continue
        _close(tparams[name].numpy(), v.numpy(), 1e-4)
    Xc, yc, Xq, mask = _inputs(kind)
    args = (T(Xc), T(yc), T(Xq), T(mask))
    with torch.no_grad():
        outs = [torch.func.functional_call(tm, prm, args) for prm in (tparams, want)]
    for a, b in zip(*outs):
        _close(a.numpy(), b.numpy(), 1e-4)


@pytest.fixture(scope="module")
def surrogates():
    """JAX NAP surrogates (d_model 16, one layer) fitted on 12 points and
    carried into the port: {kind: (jax, port, space)}.  The JAX package's
    meta-training cache is filled beforehand with perturbed initial params
    (its key: dim_x, d_model, n_layers, meta_steps, categorical columns), so
    no JAX meta-training is compiled; the keys are removed afterwards."""
    out, keys = {}, []
    for kind, spec in (("numeric", NUM), ("mixed", MIXED)):
        js, ts = JSpace(spec), DesignSpace(spec)
        cat = tuple(int(c) for c in js.cat_dims)
        ncat = tuple(int(js.num_categories[c]) for c in cat)
        jmod = jnap.TransformerNP(dim_x=js.num_cols, d_model=16, n_layers=1, cat_dims=cat,
                                  num_categories=ncat)
        Xd = jnp.zeros((1, 3, js.num_cols))
        p = jmod.init(jax.random.PRNGKey(5), Xd, jnp.zeros((1, 3, 1)), Xd, jnp.ones((1, 3), bool))
        p = jax.tree.map(lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(6), a.shape), p)
        key = (js.num_cols, 16, 1, SMALL["meta_steps"], cat, ncat)
        jnap.NAPSurrogate._pretrained[key] = p
        keys.append(key)
        X = ts.transform(ts.sample(12, seed=1)).astype(np.float32)
        y = (X[:, :1].astype(float) ** 2 + 0.5 * X[:, 1:2]).astype(np.float32)
        jm = jnap.NAPSurrogate(js, **SMALL).fit(X, y)
        tm = model_from_jax(jm, tnap.NAPSurrogate(ts, device="cpu", **SMALL).fit(X, y))
        out[kind] = (jm, tm, ts)
    yield out
    for key in keys:
        jnap.NAPSurrogate._pretrained.pop(key, None)


@pytest.mark.parametrize("kind", ["numeric", "mixed"])
def test_nap_surrogate_predict_on_carried_state(surrogates, kind):
    jm, tm, ts = surrogates[kind]
    Q = ts.transform(ts.sample(10, seed=4)).astype(np.float32)
    for a, b in zip(tm.predict(Q), jm.predict(Q)):
        _close(a, b, 1e-5)
    for a, b in zip(tm.predict_pure(tm.state, T(Q)), jm.predict_pure(jm.state, jnp.asarray(Q))):
        _close(a.numpy(), b, 1e-5)
    np.testing.assert_array_equal(tm._num_mask, jm._num_mask)


def test_nap_surrogate_caches_its_meta_training():
    ts = DesignSpace(NUM)
    a = tnap.NAPSurrogate(ts, device="cpu", meta_steps=3, d_model=8, n_layers=1)
    b = tnap.NAPSurrogate(ts, device="cpu", meta_steps=3, d_model=8, n_layers=1)
    assert a.params is b.params and b.meta_train_s == 0.0
    X = ts.transform(ts.sample(16, seed=0))
    mu, var = a.fit(X, np.sum(X ** 2, axis=1, keepdims=True)).predict(X)
    assert mu.shape == (16, 1) and np.all(np.isfinite(mu)) and np.all(var > 0)


def test_meta_training_reduces_loss():
    """tests/test_latent_meta.py's descent check (150 steps), from the
    port's own draws."""
    model = tnap.TransformerNP(dim_x=2, d_model=32, n_layers=2,
                               generator=torch.Generator().manual_seed(0))
    _, losses = tnap.meta_train_np(model, torch.Generator().manual_seed(0), n_steps=150)
    assert np.mean(losses[-25:]) < np.mean(losses[:25]) - 0.05


def _objective(df):
    X = df.values.astype(float)
    return np.sum(X ** 2, axis=1, keepdims=True)


def test_hebo_suggests_with_nap():
    import hebo_tpu_torch.meta  # noqa: F401  (registers "nap")

    space = DesignSpace(NUM)
    opt = HEBO(space, model_name="nap", device="cpu", pop=16, iters=4,
               model_config={"meta_steps": 5, "d_model": 16, "n_layers": 1})
    rec = opt.suggest(3)  # the Sobol phase: 1 + D points
    opt.observe(rec, _objective(rec))
    for _ in range(3):
        rec = opt.suggest(4)
        X = space.transform(rec)
        assert np.isfinite(X).all() and (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
        opt.observe(rec, _objective(rec))
    assert type(opt.model).__name__ == "NAPSurrogate" and len(opt.fit_time) == 3
    assert np.isfinite(opt.best_y)


def test_nap_in_bo_builder_loop(monkeypatch):
    """tests/test_latent_meta.py::test_nap_in_bo_loop on the port."""
    import hebo_tpu_torch.meta  # noqa: F401  (registers "nap")
    from hebo_tpu_torch.optimizers import bo_builder

    monkeypatch.setitem(bo_builder.MODEL_REGISTRY_MAP, "nap", ("nap", {}))
    opt = bo_builder.BoBuilder("nap", "rs", "ei", "none", model_kwargs={
        "meta_steps": 5, "d_model": 16, "n_layers": 1}).build_bo(DesignSpace(NUM), n_init=4,
                                                                  device="cpu")
    for _ in range(4):
        rec = opt.suggest(2)
        opt.observe(rec, _objective(rec))
    assert np.isfinite(opt.best_y) and type(opt.model).__name__ == "NAPSurrogate"
