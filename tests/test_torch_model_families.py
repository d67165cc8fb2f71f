"""The other surrogate families in hebo_tpu_torch (deep ensembles with MCBN,
Gumbel and conditional variants, EAC, the monotone layers, the random
forest and the oblivious-tree GBDT) against hebo_tpu on CPU.

The same numpy-seeded inputs go through both packages, with the JAX
package's random draws fed to the port.  Tolerances (float32 both sides):
* featurizing, GBDT binning (host and device), the random forest with
  numpy's global seed set before each fit: identical;
* the ensembles' and EAC's forwards on carried-across params: 1e-5 of the
  largest |value|; the fits after a few Adam epochs from the JAX package's
  initial draws (and, for Gumbel, its gate noise), and their predictions:
  1e-4;
* the monotone layers on carried-across params: 1e-6;
* the GBDT forest grown with the JAX package's row bags and leaf noise:
  the same split features and bins (or, where the port's argmax differs,
  two scores that tie within float32 rounding, and then the forest grown
  from the JAX package's splits), leaf values and predictions at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.models import MODEL_REGISTRY as JREG
from hebo_tpu.models import get_model as jget_model
from hebo_tpu.models.boosting import _fit_forest as j_fit_forest
from hebo_tpu.models.boosting import _predict_forest as j_predict_forest
from hebo_tpu.models.nn.deep_ensemble import _init_mlp as j_init_mlp
from hebo_tpu.models.nn.deep_ensemble import _mlp_forward as j_mlp_forward
from hebo_tpu_torch import HEBO
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.models import get_model
from hebo_tpu_torch.models.base import MODEL_REGISTRY
from hebo_tpu_torch.models.boosting import GBDT, fit_forest, predict_forest
from hebo_tpu_torch.models.convert import eac_from_jax, ensemble_from_jax
from hebo_tpu_torch.models.gp import model_from_jax
from hebo_tpu_torch.models.nn.deep_ensemble import mlp_forward
from hebo_tpu_torch.models.nn.eac import cell_forward
from hebo_tpu_torch.models.nn.mono_layers import Lattice1D, MonotoneMLP

CONT = [{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(3)]
MIXED = CONT + [{"name": "c", "type": "cat", "categories": ["a", "b", "c"]}]
CATONLY = [{"name": "c0", "type": "cat", "categories": ["a", "b", "c"]},
           {"name": "c1", "type": "cat", "categories": ["x", "y"]},
           {"name": "c2", "type": "cat", "categories": ["p", "q", "r", "s"]}]
SPACES = {"cont": CONT, "mixed": MIXED, "cat": CATONLY}
T = torch.as_tensor
SMALL = {"num_epochs": 5, "num_ensembles": 3, "num_hiddens": 16}


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


def _xy(spec, n=24, seed=0):
    space = DesignSpace(spec)
    X = space.transform(space.sample(n, seed=seed)).astype(np.float32)
    rng = np.random.default_rng(seed)
    y = (np.sin(2 * X[:, :1]) + X[:, -1:] ** 2 - 0.3 * X[:, 1:2]
         + 0.05 * rng.standard_normal((n, 1))).astype(np.float32)
    return X, y


def _leaves(p):
    return [np.asarray(t) for t in jax.tree_util.tree_leaves(p)]


def _tleaves(p):
    from hebo_tpu_torch.models.gp.tree import tree_leaves

    return [t.detach().numpy() for t in tree_leaves(p)]


def _jax_member_inits(seed, E, sizes):
    """The JAX ensemble's initial weights at PRNGKey(seed)."""
    return jax.vmap(lambda k: j_init_mlp(k, sizes))(jax.random.split(jax.random.PRNGKey(seed), E))


# ----------------------------------------------------------- featurizing
@pytest.mark.parametrize("spec", list(SPACES), ids=list(SPACES))
@pytest.mark.parametrize("name", ["deep_ensemble", "rf", "conditional_deep_ensemble"])
def test_featurize_is_identical(name, spec):
    js, ts = JSpace(SPACES[spec]), DesignSpace(SPACES[spec])
    X, _ = _xy(SPACES[spec])
    conf = {}
    if name == "conditional_deep_ensemble":
        conf["active_fn"] = lambda Xo: np.arange(Xo.shape[1])[None, :] != (Xo[:, :1] > 0)
    jf = jget_model(name, js, **conf)._featurize(X.astype(np.float64))
    tm = get_model(name, ts, device="cpu", **conf)
    np.testing.assert_array_equal(tm._featurize(X.astype(np.float64)), jf)
    if name == "deep_ensemble":  # the device featurization of predict_pure
        np.testing.assert_array_equal(tm._featurize_t(T(X)).numpy(), jf.astype(np.float32))


@pytest.mark.parametrize("spec", list(SPACES), ids=list(SPACES))
def test_gbdt_binning_is_identical(spec):
    js, ts = JSpace(SPACES[spec]), DesignSpace(SPACES[spec])
    X, _ = _xy(SPACES[spec], n=32)
    jm, tm = jget_model("gbdt", js, n_bins=8), get_model("gbdt", ts, device="cpu", n_bins=8)
    jm._bin_fit(X)
    tm._bin_fit(X)
    assert tm._feature_spec() == jm._feature_spec()
    for a, b in zip(tm._edges, jm._edges):
        np.testing.assert_array_equal(a, b)
    Q = np.concatenate([X, ts.transform(ts.sample(16, seed=5)).astype(np.float32)])
    if ts.numeric_dims:  # values exactly on the edges
        d = ts.numeric_dims[0]
        Q[:8, d] = jm._edges[d][:8] if len(jm._edges[d]) >= 8 else Q[:8, d]
    codes = jm._bin_apply(Q)
    np.testing.assert_array_equal(tm._bin_apply(Q), codes)
    jdev = np.asarray(jm._bin_apply_jnp(jnp.asarray(Q), *jm._device_binning()))
    tdev = tm._bin_apply_t(T(Q), *tm._device_binning()).numpy()
    np.testing.assert_array_equal(jdev, codes)
    np.testing.assert_array_equal(tdev, codes)


# -------------------------------------------------------- deep ensemble
@pytest.fixture(scope="module")
def ensembles():
    """JAX ensembles fitted once on MIXED, {name: (jax model, its init)}:
    deep_ensemble with the NLL and the MSE loss, MCBN, and the
    conditional ensemble with an active_fn."""
    js = JSpace(MIXED)
    X, y = _xy(MIXED)
    active = lambda Xo: np.arange(Xo.shape[1])[None, :] != np.where(Xo[:, :1] > 0, 1, -1)  # noqa: E731
    out = {}
    for name, model, conf in (("nll", "deep_ensemble", {}), ("mse", "deep_ensemble", {"loss": "mse"}),
                              ("mcbn", "mcbn", {}),
                              ("conditional", "conditional_deep_ensemble", {"active_fn": active})):
        jm = jget_model(model, js, seed=3, **SMALL, **conf)
        jm.fit(X, y)
        d = jm._featurize(X[:1].astype(np.float64)).shape[1]
        init = _jax_member_inits(4, jm.num_ensembles, [d] + [16, 16] + [2])
        out[name] = (jm, init, model, conf)
    return out, X, y


def test_mlp_forward_on_carried_params(ensembles):
    fitted, X, _ = ensembles
    jm = fitted["nll"][0]
    F = np.random.default_rng(0).standard_normal((24, jm.params.w[0].shape[1])).astype(np.float32)
    mus, vars_ = jax.vmap(lambda p: j_mlp_forward(p, jnp.asarray(F)))(jm.params)
    tmu, tvar = mlp_forward(ensemble_from_jax(jm.params, device="cpu"), T(F))
    _close(tmu.numpy(), mus, 1e-5)
    _close(tvar.numpy(), vars_, 1e-5)


@pytest.mark.parametrize("name", ["nll", "mse", "mcbn", "conditional"])
def test_ensemble_fit_from_the_jax_init(ensembles, name):
    """5 epochs from the JAX package's initial weights with the same
    bootstrap counts: the params, predict and predict_pure at 1e-4."""
    fitted, X, y = ensembles
    jm, init, model, conf = fitted[name]
    tm = get_model(model, DesignSpace(MIXED), device="cpu", seed=3, **SMALL, **conf)
    tm.fit(X, y, init=ensemble_from_jax(init, device="cpu"))
    assert tm._seed == jm._seed
    for a, b in zip(_tleaves(tm.params), _leaves(jm.params)):
        _close(a, b, 1e-4)
    Q = DesignSpace(MIXED).transform(DesignSpace(MIXED).sample(16, seed=9)).astype(np.float32)
    for a, b in zip(tm.predict(Q), jm.predict(Q)):
        _close(a, b, 1e-4)
    if name in ("nll", "mse"):
        for a, b in zip(tm.predict_pure(tm.state, T(Q)), jm.predict_pure(jm.state, jnp.asarray(Q))):
            _close(a.numpy(), b, 1e-4)
        draws = tm.sample_f(4, seed=1)(Q)
        _close(draws, jm.sample_f(4, seed=1)(Q), 1e-4)


def test_carried_ensembles_predict_as_the_jax_package(ensembles):
    fitted, X, _ = ensembles
    for name in ("nll", "mcbn"):
        jm, _, model, conf = fitted[name]
        tm = model_from_jax(jm, get_model(model, DesignSpace(MIXED), device="cpu", **SMALL, **conf))
        for a, b in zip(tm.predict(X), jm.predict(X)):
            _close(a, b, 1e-5)


def test_gumbel_fit_with_fed_gumbels_and_feature_importance():
    js, ts = JSpace(CONT), DesignSpace(CONT)
    X, y = _xy(CONT)
    conf = dict(SMALL, num_ensembles=2)
    jm = jget_model("gumbel", js, seed=5, **conf).fit(X, y)
    E, d, epochs = 2, 3, conf["num_epochs"]
    inits, gumbels = [], []
    for k in jax.random.split(jax.random.PRNGKey(6), E):  # the fit's PRNGKey(seed + 1)
        k0, k1 = jax.random.split(k)
        inits.append(j_init_mlp(k0, [d, 16, 16, 2]))
        gumbels.append(np.stack([np.asarray(jax.random.gumbel(kk, (d,)))
                                 for kk in jax.random.split(k1, epochs)]))
    init_mlp = jax.tree.map(lambda *a: jnp.stack(a), *inits)
    from hebo_tpu_torch.models.nn.ensembles_ext import GumbelParams

    init = GumbelParams(mlp=ensemble_from_jax(init_mlp, device="cpu"), gate_logits=torch.ones((E, d)))
    tm = get_model("gumbel", ts, device="cpu", seed=5, **conf)
    tm.fit(X, y, init=init, gumbels=T(np.stack(gumbels)))
    for a, b in zip(_tleaves(tm.params), _leaves(jm.params)):
        _close(a, b, 1e-4)
    _close(tm.feature_importance(), jm.feature_importance(), 1e-4)
    for a, b in zip(tm.predict(X), jm.predict(X)):
        _close(a, b, 1e-4)


def test_conditional_featurization_masks_and_appends():
    ts = DesignSpace(CONT)
    X, _ = _xy(CONT)

    def active(Xo):  # dim 2 inactive when x0 < 0 (tests/test_ensembles_ext.py's rule)
        m = np.ones_like(Xo, dtype=bool)
        m[:, 2] = Xo[:, 0] >= 0
        return m

    F = get_model("conditional_deep_ensemble", ts, device="cpu", active_fn=active)._featurize(
        X.astype(np.float64))
    assert F.shape == (len(X), 6)
    np.testing.assert_array_equal(F[:, 5], X[:, 0] >= 0)
    np.testing.assert_array_equal(F[X[:, 0] < 0, 2], 0.0)


# ------------------------------------------------------------------- EAC
EAC_CONF = {"num_epochs": 4, "num_ensembles": 2, "num_hiddens": 8, "emb_dim": 4}


@pytest.fixture(scope="module")
def eacs():
    js = JSpace(CATONLY)
    X, y = _xy(CATONLY, n=20)
    out = {}
    for cell in ("mlp", "rnn", "transformer"):
        jm = jget_model("eac", js, cell=cell, seed=2, **EAC_CONF)
        init = jax.vmap(jm._init_member)(jax.random.split(jax.random.PRNGKey(2), 2))
        jm.fit(X, y)
        out[cell] = (jm, init)
    return out, X, y


@pytest.mark.parametrize("cell", ["mlp", "rnn", "transformer"])
def test_eac_forward_on_carried_params(eacs, cell):
    fitted, X, _ = eacs
    jm = fitted[cell][0]
    tm = get_model("eac", DesignSpace(CATONLY), device="cpu", cell=cell, **EAC_CONF)
    codes = jm._codes(X)
    mus, vars_ = jax.vmap(lambda p: jm._forward(p, jnp.asarray(codes)))(jm.params)
    tmu, tvar = tm._forward(eac_from_jax(jm.params, device="cpu"), tm._codes(X))
    _close(tmu.numpy(), mus, 1e-5)
    _close(tvar.numpy(), vars_, 1e-5)


@pytest.mark.parametrize("cell", ["mlp", "rnn", "transformer"])
def test_eac_fit_from_the_jax_init(eacs, cell):
    fitted, X, y = eacs
    jm, init = fitted[cell]
    tm = get_model("eac", DesignSpace(CATONLY), device="cpu", cell=cell, seed=2, **EAC_CONF)
    tm.fit(X, y, init=eac_from_jax(init, device="cpu"))
    for a, b in zip(_tleaves(tm.params), _leaves(jm.params)):
        _close(a, b, 1e-4)
    for a, b in zip(tm.predict(X), jm.predict(X)):
        _close(a, b, 1e-4)
    _close(tm.sample_f(3, seed=1)(X[:5]), jm.sample_f(3, seed=1)(X[:5]), 1e-4)
    assert not hasattr(tm, "state") and not hasattr(jm, "state")


def test_eac_cells_directly():
    """The recurrence is the JAX package's own gated cell (not
    ``torch.nn.GRU``): one step from h = 0 by hand."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn((1, 2, 1, 3), generator=g)
    wx, wh, b = torch.randn((1, 3, 6), generator=g), torch.randn((1, 2, 6), generator=g), torch.zeros(1, 6)
    r, u, n = torch.chunk(x[0, :, 0] @ wx[0], 3, -1)
    want = (1 - torch.sigmoid(u)) * torch.tanh(n * torch.sigmoid(r))
    _close(cell_forward("rnn", (wx, wh, b), x)[0].numpy(), want.numpy(), 1e-6)


# ------------------------------------------------------- monotone layers
def test_monotone_layers_on_carried_params():
    from hebo_tpu.models.nn.mono_layers import Lattice1D as JLattice
    from hebo_tpu.models.nn.mono_layers import MonotoneMLP as JMono

    deltas = jax.random.normal(jax.random.PRNGKey(1), (8,))
    jl = JLattice.init(jax.random.PRNGKey(0), 8)._replace(deltas=deltas, bias=jnp.asarray(0.3))
    tl = Lattice1D.init(8, device="cpu")._replace(deltas=T(np.array(deltas)), bias=torch.tensor(0.3))
    x = np.linspace(0, 1, 50, dtype=np.float32)[:, None]
    y = tl(T(x)).numpy()[:, 0]
    _close(y, np.asarray(jl(jnp.asarray(x)))[:, 0], 1e-6)
    assert np.all(np.diff(y) >= -1e-6)

    jn = JMono.init(jax.random.PRNGKey(0), d_in=2, mono_mask=[1.0, 0.0], hidden=8)
    tn = MonotoneMLP.init(2, [1.0, 0.0], hidden=8, normals=[np.asarray(w) / 0.5 for w in jn.ws],
                          device="cpu")
    for a, b in zip(tn.ws, jn.ws):
        _close(a.numpy(), b, 1e-6)
    xs = np.concatenate([np.linspace(-1, 1, 50, dtype=np.float32)[:, None],
                         np.zeros((50, 1), np.float32)], 1)
    out = tn(T(xs)).numpy()[:, 0]
    _close(out, np.asarray(jn(jnp.asarray(xs)))[:, 0], 1e-6)
    assert np.all(np.diff(out) >= -1e-5)  # monotone in the flagged input


# -------------------------------------------------------------------- RF
@pytest.mark.parametrize("spec", ["mixed", "cat"])
def test_rf_with_numpy_seed_is_identical(spec):
    js, ts = JSpace(SPACES[spec]), DesignSpace(SPACES[spec])
    X, y = _xy(SPACES[spec])
    y[4, 0] = np.nan  # the non-finite row is dropped by both
    np.random.seed(11)
    jm = jget_model("rf", js, n_estimators=8).fit(X, y)
    np.random.seed(11)
    tm = get_model("rf", ts, device="cpu", n_estimators=8).fit(X, y)
    Q = ts.transform(ts.sample(12, seed=3))
    for a, b in zip(tm.predict(Q), jm.predict(Q)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.noise, jm.noise)


# ------------------------------------------------------------------ GBDT
def _jax_rounds(key, n_rounds, N, L, subsample):
    """The JAX forest's per-round row bags (R, N) and leaf noise (R, L, 2)."""
    bags, eps = [], []
    for kr in jax.random.split(key, n_rounds):
        kr, kn = jax.random.split(kr)
        bags.append(np.asarray(jax.random.bernoulli(kr, subsample, (N,))))
        eps.append(np.asarray(jax.random.normal(kn, (L, 2))))
    return np.stack(bags), np.stack(eps)


@pytest.fixture(scope="module")
def gbdt_case():
    """A GBDT fitted by the JAX package on MIXED (a categorical column of 3,
    so two of its one-hot splits partition alike) with a NaN row."""
    js = JSpace(MIXED)
    X, y = _xy(MIXED, n=30)
    y[7, 0] = np.nan
    conf = {"num_epochs": 20, "depth": 3, "n_bins": 8}
    jm = jget_model("gbdt", js, **conf).fit(X, y)
    return jm, conf, X, y


def test_gbdt_fit_forest_with_the_jax_draws(gbdt_case):
    jm, conf, X, y = gbdt_case
    ok = np.isfinite(y[:, 0])
    codes = jm._bin_apply(X[ok])
    n, n_pad, R, L = len(codes), 32, jm.n_rounds, 2 ** jm.depth
    cp = np.zeros((n_pad, codes.shape[1]), np.int32)
    cp[:n] = codes
    yv = y[ok, 0]
    yp = np.zeros(n_pad, np.float32)
    yp[:n] = (yv - jm._y_mean) / jm._y_std
    mk = np.arange(n_pad) < n
    key = jax.random.PRNGKey(42 + n)
    bags, eps = _jax_rounds(key, R, n_pad, L, 0.8)
    jf = j_fit_forest(key, jnp.asarray(cp), jnp.asarray(yp), jnp.asarray(mk), n_rounds=R,
                      depth=jm.depth, n_bins=jm.n_bins, lr=jm.lr, lam=jm.lam, subsample=0.8)
    np.testing.assert_array_equal(np.asarray(jf.leaf_w), np.asarray(jm.forest.leaf_w))
    args = dict(n_rounds=R, depth=jm.depth, n_bins=jm.n_bins, lr=jm.lr, lam=jm.lam,
                bags=T(bags), eps=T(eps))
    free = fit_forest(T(cp), T(yp), T(mk), **args)
    jfe, jbi = np.asarray(jf.feats), np.asarray(jf.bins)
    same = (free.feats.numpy() == jfe) & (free.bins.numpy() == jbi)
    trace = []
    forced = fit_forest(T(cp), T(yp), T(mk), splits=(T(jfe), T(jbi)), trace=trace, **args)
    if same.all():
        _close(free.leaf_w.numpy(), jf.leaf_w, 1e-5)
    else:  # the first split that differs must be a tie within float32 rounding
        r, t = np.argwhere(~same)[0]
        score = trace[r * jm.depth + t]
        mine = score[free.feats[r, t], free.bins[r, t]]
        theirs = score[int(jfe[r, t]), int(jbi[r, t])]
        assert abs(float(mine - theirs)) <= 1e-5 * abs(float(mine)), (r, t, mine, theirs)
    _close(forced.leaf_w.numpy(), jf.leaf_w, 1e-5)
    Q = np.asarray(jm._bin_apply(X), np.int32)
    for a, b in zip(predict_forest(forced, T(Q), jm.num_ensembles),
                    j_predict_forest(jf, jnp.asarray(Q), jm.num_ensembles)):
        _close(a.numpy(), b, 1e-5)


def test_gbdt_predict_and_predict_pure_on_carried_forest(gbdt_case):
    jm, conf, X, _ = gbdt_case
    tm = model_from_jax(jm, get_model("catboost", DesignSpace(MIXED), device="cpu", **conf))
    Q = DesignSpace(MIXED).transform(DesignSpace(MIXED).sample(20, seed=4)).astype(np.float32)
    for a, b in zip(tm.predict(Q), jm.predict(Q)):
        _close(a, b, 1e-5)
    for a, b in zip(tm.predict_pure(tm.state, T(Q)), jm.predict_pure(jm.state, jnp.asarray(Q))):
        _close(a.numpy(), b, 1e-5)
    for a, b in zip(tm.predict_pure(tm.state, T(Q)), tm.predict(Q)):
        _close(a.numpy(), b, 1e-5)


def _space(d=2):
    return DesignSpace([{"name": f"x{i}", "type": "num", "lb": -2.0, "ub": 2.0} for i in range(d)])


def test_gbdt_fits_smooth_function():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (80, 2)).astype(np.float32)
    y = ((X[:, 0] - 0.5) ** 2 + (X[:, 1] + 0.3) ** 2).reshape(-1, 1)
    m = get_model("gbdt", _space(), device="cpu", num_epochs=60).fit(X, y)
    g = rng.uniform(-2, 2, (40, 2)).astype(np.float32)
    mu, var = m.predict(g)
    assert np.corrcoef(mu[:, 0], (g[:, 0] - 0.5) ** 2 + (g[:, 1] + 0.3) ** 2)[0, 1] > 0.7
    assert np.all(var > 0)


def test_gbdt_min_iterations_guard():
    # reference: iterations >= 2 * num_ensembles (catboost.py:29-30)
    m = get_model("catboost", _space(), device="cpu", num_epochs=5, num_ensembles=10)
    assert isinstance(m, GBDT) and m.n_rounds == 20


def test_gbdt_uncertainty_grows_away_from_data():
    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 0, (60, 1)).astype(np.float32)  # only the left half of the box
    m = get_model("gbdt", _space(1), device="cpu", num_epochs=60).fit(X, np.sin(2 * X))
    _, var_in = m.predict(np.asarray([[-1.0]], np.float32))
    _, var_out = m.predict(np.asarray([[1.9]], np.float32))
    assert var_out[0, 0] > var_in[0, 0]


def test_gbdt_nan_rows_filtered():
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, (30, 2)).astype(np.float32)
    y = np.sum(X, axis=1, keepdims=True)
    y[3, 0], y[7, 0] = np.inf, np.nan
    m = get_model("gbdt", _space(), device="cpu", num_epochs=25).fit(X, y)
    mu, var = m.predict(X)
    assert np.all(np.isfinite(mu)) and np.all(np.isfinite(var))


def test_bo_loop_with_catboost_runs():
    """tests/test_boosting.py's loop (24 rounds of ``BO`` with catboost at
    40 rounds; NSGA-II cut to pop 20 × 8 generations here).  Its "improves
    on the first 5" holds on the JAX package's stream at random_seed 42
    only: at seeds 42-49 the JAX package's loop (at its defaults)
    re-suggests the incumbent to the end on 5 of 8, the port's on 6 of 8
    (ROADMAP §3), so this test holds the loop's suggestions and best value,
    not an improvement."""
    from hebo_tpu_torch.optimizers import BO

    space = _space()
    f = lambda df: ((df["x0"].values - 0.5) ** 2 + (df["x1"].values + 0.3) ** 2).reshape(-1, 1)  # noqa: E731
    opt = BO(space, model_name="catboost", device="cpu", pop=20, iters=8,
             model_config={"num_epochs": 40})
    ys = []
    for _ in range(24):
        rec = opt.suggest(1)
        X = space.transform(rec)
        assert np.isfinite(X).all() and (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
        y = f(rec)
        opt.observe(rec, y)
        ys.append(float(y[0, 0]))
    assert isinstance(opt.model, GBDT) and len(opt.fit_time) == 21
    assert opt.best_y == min(ys) <= min(ys[:5])


# --------------------------------------------------------- the HEBO loop
def _objective(df):
    X = df[["x0", "x1", "x2"]].values.astype(float)
    return ((X ** 2).sum(1) + (df["c"].values == "b")).reshape(-1, 1)


LOOP = {"deep_ensemble": {"num_epochs": 8, "num_hiddens": 16},
        "mcbn": {"num_epochs": 8, "num_hiddens": 16},
        "conditional_deep_ensemble": {"num_epochs": 8, "num_hiddens": 16},
        "gbdt": {"num_epochs": 20}, "catboost": {"num_epochs": 20}}


@pytest.mark.parametrize("name", list(LOOP))
def test_hebo_suggests_with_each_model(name):
    space = DesignSpace(MIXED)
    opt = HEBO(space, model_name=name, device="cpu", pop=16, iters=4, model_config=LOOP[name])
    rec = opt.suggest(6)  # the Sobol phase: 1 + D points
    opt.observe(rec, _objective(rec))
    for _ in range(3):
        rec = opt.suggest(4)
        X = space.transform(rec)
        assert len(rec) == 4 and np.isfinite(X).all()
        assert (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
        opt.observe(rec, _objective(rec))
    assert opt.num_obs == 18 and np.isfinite(opt.best_y) and len(opt.fit_time) == 3


@pytest.mark.parametrize("name,message", [("rf", "'RF' object has no attribute 'state'"),
                                          ("eac", "'EACEnsemble' object has no attribute 'state'"),
                                          ("gumbel", "'GumbelParams' object has no attribute 'w'")])
def test_hebo_reproduces_the_reference_attribute_errors(name, message):
    """RF and EAC have no ``state`` and the Gumbel ensemble's inherited
    ``predict_pure`` reads ``params.w``: HEBO's generic route raises the same
    ``AttributeError`` in both packages (ROADMAP §3)."""
    from hebo_tpu.optimizers.hebo import HEBO as JHEBO

    conf = {"n_estimators": 4} if name == "rf" else {"num_epochs": 3}
    for opt in (JHEBO(JSpace(MIXED), model_name=name, pop=16, iters=2, model_config=conf),
                HEBO(DesignSpace(MIXED), model_name=name, device="cpu", pop=16, iters=2,
                     model_config=conf)):
        rec = opt.suggest(6)  # the Sobol phase: 1 + D points
        opt.observe(rec, _objective(rec))
        with pytest.raises(AttributeError) as err:
            opt.suggest(4)
        assert str(err.value) == message


def test_every_jax_model_id_builds_in_the_port():
    import hebo_tpu.meta  # noqa: F401  (registers "nap")
    import hebo_tpu_torch.meta  # noqa: F401
    from hebo_tpu.optimizers.bo_builder import MODEL_REGISTRY_MAP as JMAP
    from hebo_tpu_torch.optimizers import bo_builder
    from hebo_tpu_torch.optimizers import hebo as thebo

    assert set(JREG) <= set(MODEL_REGISTRY)
    assert set(JMAP) <= set(bo_builder.MODEL_REGISTRY_MAP)
    assert not hasattr(thebo, "_NOT_PORTED") and not hasattr(bo_builder, "_NOT_PORTED")
    space = DesignSpace(MIXED)
    for name in sorted(JREG):
        conf = {"meta_steps": 1, "d_model": 8, "n_layers": 1} if name == "nap" else {}
        assert get_model(name, space, device="cpu", **conf).model_name in (name, "gbdt")
