"""Latent-space BO in hebo_tpu_torch (``latent/*``) against hebo_tpu on CPU.

The same numpy-seeded inputs go through both packages; the flax parameters
are carried across (``latent/convert.py``) and the JAX package's
reparameterisation draws (its key schedule, ``k, ks = split(k);
normal(ks, mu.shape)`` per step, replayed) are fed to the port.
Tolerances (float32 both sides, relative to the largest |value|):
* ``rank_weights`` exactly; ``metric_loss`` and its gradient 1e-5;
* every VAE's forward, encode and decode 1e-5, the greedy tokens exactly;
* three ``train_*`` steps from the JAX package's init with its draws: the
  losses and the parameters 1e-4;
* the chem functions exactly; the batched chem decode equal to the JAX
  package's per-row decode;
* ``LatentSpaceBO``'s decode-and-dedupe picks equal to the JAX package's
  from a carried state and the same population.
The JAX package's own loop tests run on the port at their sizes.
"""

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp

from hebo_tpu.design_space import DesignSpace as JSpace
from hebo_tpu.latent import chem as jchem
from hebo_tpu.latent import decoders as jdec
from hebo_tpu.latent import lbo as jlbo
from hebo_tpu.latent import vae as jvae
from hebo_tpu_torch.design_space import DesignSpace
from hebo_tpu_torch.latent import chem as tchem
from hebo_tpu_torch.latent import decoders as tdec
from hebo_tpu_torch.latent import lbo as tlbo
from hebo_tpu_torch.latent import vae as tvae
from hebo_tpu_torch.latent.convert import seq_vae_from_flax, topology_vae_from_flax, vae_from_flax

T = torch.as_tensor
CONT = [{"name": f"x{i}", "type": "num", "lb": -1, "ub": 1} for i in range(8)]
CATS = [{"name": f"c{i}", "type": "cat", "categories": list("abcd")} for i in range(6)]


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


def _jax_noise(key, n_steps, shape):
    """The normals ``hebo_tpu``'s ``train_*`` scans draw, step by step."""
    out = []
    for _ in range(n_steps):
        key, ks = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(ks, shape)))
    return np.stack(out)


# ------------------------------------------------------------- weights, loss
def test_rank_weights_and_metric_loss_against_the_reference():
    rng = np.random.default_rng(0)
    y = rng.standard_normal(17)
    np.testing.assert_array_equal(tvae.rank_weights(y, 1e-2), jvae.rank_weights(y, 1e-2))
    z = rng.standard_normal((12, 3)).astype(np.float32)
    yy = (rng.standard_normal((12, 1)) * 0.3).astype(np.float32)
    mask = rng.random(12) < 0.7
    for m in (None, mask):
        jm = None if m is None else jnp.asarray(m)
        tm = None if m is None else T(m)
        val, g = jax.value_and_grad(lambda a: jvae.metric_loss(a, jnp.asarray(yy), mask=jm))(jnp.asarray(z))
        zt = T(z).requires_grad_(True)
        tv = tvae.metric_loss(zt, T(yy), mask=tm)
        (gt,) = torch.autograd.grad(tv, zt)
        _close(tv.detach().numpy(), val, 1e-5)
        _close(gt.numpy(), g, 1e-5)


# ------------------------------------------------------------------- forwards
@pytest.fixture(scope="module")
def carried():
    """Each JAX VAE family at a small width with its init params, and the
    port's module carrying them."""
    key = jax.random.PRNGKey(0)
    out = {}
    for name, cat in (("continuous", ()), ("categorical", (4, 4, 4, 4, 4, 4))):
        jm = jvae.VAE(latent_dim=3, out_dim=6, hidden=16, categorical_dims=cat)
        p = jm.init({"params": key}, jnp.zeros((1, 6)), key)["params"]
        tm = tvae.VAE(3, 6, 16, cat, device="cpu")
        out[name] = (jm, p, tm, vae_from_flax(p, tm))
    for hw in ((24, 24), (25, 25)):
        jm = jdec.TopologyVAE(latent_dim=4, image_hw=hw, width=8)
        p = jm.init({"params": key}, jnp.zeros((1,) + hw + (1,)), key)["params"]
        tm = tdec.TopologyVAE(4, hw, 8, device="cpu")
        out[hw] = (jm, p, tm, topology_vae_from_flax(p, tm))
    jm = jdec.SeqVAE(vocab=6, length=10, latent_dim=4, hidden=16)
    p = jm.init({"params": key}, jnp.zeros((1, 10), jnp.int32), key)["params"]
    tm = tdec.SeqVAE(6, 10, 4, 16, device="cpu")
    out["seq"] = (jm, p, tm, seq_vae_from_flax(p, tm))
    return out


def _data(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "continuous":
        X = rng.uniform(-1, 1, (n, 6)).astype(np.float32)
    elif kind == "categorical":
        X = rng.integers(0, 4, (n, 6)).astype(np.float32)
    elif kind == "seq":
        X = rng.integers(0, 6, (n, 10)).astype(np.int32)
    else:
        X = (rng.random((n,) + kind + (1,)) < 0.3).astype(np.float32)
    y = X.reshape(n, -1).mean(1, keepdims=True).astype(np.float32)
    return X, y


@pytest.mark.parametrize("kind", ["continuous", "categorical"])
def test_vae_forward_encode_decode_with_carried_weights(carried, kind):
    jm, p, tm, tp = carried[kind]
    X, _ = _data(kind, 9)
    eps = np.random.default_rng(1).standard_normal((9, 3)).astype(np.float32)
    mu_j, ls_j = jm.apply({"params": p}, jnp.asarray(X), method=jm.encode)
    out_t, mu_t, ls_t = functional_call(tm, tp, (T(X), T(eps)))
    _close(mu_t.detach(), mu_j, 1e-5)
    _close(ls_t.detach(), ls_j, 1e-5)
    z = np.asarray(mu_j) + np.exp(np.asarray(ls_j)) * eps
    dec_j = jm.apply({"params": p}, jnp.asarray(z), method=jm.decode)
    dec_t = functional_call(tm.decoder, tvae.sub_params(tp, "decoder"), (T(z),))
    for a, b in (zip(out_t, dec_j) if kind == "categorical" else [(out_t, dec_j)]):
        _close(a.detach(), b, 1e-5)
    for a, b in (zip(dec_t, dec_j) if kind == "categorical" else [(dec_t, dec_j)]):
        _close(a.detach(), b, 1e-5)


@pytest.mark.parametrize("hw", [(24, 24), (25, 25)], ids=["24x24", "25x25-odd"])
def test_topology_vae_encode_decode_with_carried_weights(carried, hw):
    jm, p, tm, tp = carried[hw]
    X, _ = _data(hw, 5)
    Zj = jdec.topology_encode(jm, p, X)
    _close(tdec.topology_encode(tm, tp, X), Zj, 1e-5)
    Z = Zj * 2.0
    imgs = tdec.topology_decode(tm, tp, Z)
    assert imgs.shape == (5,) + hw + (1,)
    _close(imgs, jdec.topology_decode(jm, p, Z), 1e-5)


def test_seq_vae_teacher_forced_logits_and_greedy_tokens(carried):
    jm, p, tm, tp = carried["seq"]
    toks, _ = _data("seq", 8)
    Zj = np.array(jdec.seq_encode(jm, p, toks))
    _close(tdec.seq_encode(tm, tp, toks), Zj, 1e-5)
    lj = jm.apply({"params": p}, jnp.asarray(Zj), jnp.asarray(toks), method=lambda m, z, t: m.decoder(z, t))
    lt = functional_call(tm.decoder, tvae.sub_params(tp, "decoder"), (T(Zj), T(toks)))
    _close(lt.detach(), lj, 1e-5)
    Z = np.random.default_rng(2).standard_normal((16, 4)).astype(np.float32) * 2
    np.testing.assert_array_equal(tdec.seq_decode(tm, tp, Z), jdec.seq_decode(jm, p, Z))


# ------------------------------------------------------------------- training
@pytest.mark.parametrize("kind", ["continuous", "categorical-labeled", "topology", "seq"])
def test_three_train_steps_with_the_reference_draws(carried, kind):
    key = jax.random.PRNGKey(3)
    n = 12
    if kind.startswith(("continuous", "categorical")):
        base = kind.split("-")[0]
        jm, p, tm, tp = carried[base]
        X, y = _data(base, n, seed=4)
        w = tvae.rank_weights(y[:, 0]).astype(np.float32)
        w[-2:] = 0.0  # padded rows
        lab = np.arange(n) < 8 if kind.endswith("labeled") else None
        pj, lj = jvae.train_vae(jm, p, key, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), n_steps=3,
                                labeled=None if lab is None else jnp.asarray(lab))
        pt, lt = tvae.train_vae(tm, tp, X, y, w, n_steps=3, labeled=lab,
                                noise=_jax_noise(key, 3, (n, 3)))
        conv = vae_from_flax
    elif kind == "topology":
        jm, p, tm, tp = carried[(24, 24)]
        X, y = _data((24, 24), n, seed=4)
        w = tvae.rank_weights(y[:, 0]).astype(np.float32)
        pj, lj = jdec.train_topology_vae(jm, p, key, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), n_steps=3)
        pt, lt = tdec.train_topology_vae(tm, tp, X, y, w, n_steps=3, noise=_jax_noise(key, 3, (n, 4)))
        conv = topology_vae_from_flax
    else:
        jm, p, tm, tp = carried["seq"]
        X, y = _data("seq", n, seed=4)
        w = tvae.rank_weights(y[:, 0]).astype(np.float32)
        pj, lj = jdec.train_seq_vae(jm, p, key, jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), n_steps=3)
        pt, lt = tdec.train_seq_vae(tm, tp, X, y, w, n_steps=3, noise=_jax_noise(key, 3, (n, 4)))
        conv = seq_vae_from_flax
    _close(lt, lj, 1e-4)
    want = conv(jax.tree.map(np.asarray, pj), tm)
    assert set(want) == set(pt)
    for k in want:
        _close(pt[k], want[k], 1e-4)


# ----------------------------------------------------------------------- chem
def test_chem_functions_equal_the_reference_on_random_streams():
    rng = np.random.default_rng(3)
    for _ in range(200):
        toks = rng.integers(0, tchem.N_TOKENS, rng.integers(0, 48))
        gj, gt = jchem.decode_tokens(toks), tchem.decode_tokens(toks)
        assert (gt.atoms, gt.bonds) == (gj.atoms, gj.bonds)
        assert tchem.canonical_string(gt) == jchem.canonical_string(gj)
        assert tchem.penalized_logp_proxy(gt) == jchem.penalized_logp_proxy(gj)
    assert tchem.ALPHABET == jchem.ALPHABET
    np.testing.assert_array_equal(tchem.random_molecules(9, 16, seed=5), jchem.random_molecules(9, 16, seed=5))


def test_chem_batched_decode_keeps_the_per_row_picks(carried):
    """The port decodes the whole population in one call; the JAX package
    decodes it row by row.  The same rows decode to the same tokens, and the
    walk keeps the same molecules."""
    jm, p, tm, tp = carried["seq"]
    bo = tchem.ChemLatentBO.__new__(tchem.ChemLatentBO)
    bo.model, bo._params = tm, tp
    Zc = np.random.default_rng(6).standard_normal((64, 4)).astype(np.float32) * 2
    batched = bo._decode(Zc)
    dec1 = jax.jit(lambda z: jm.apply({"params": p}, z, method=jm.decode))  # one compile for (1, 4)
    per_row = np.stack([np.asarray(dec1(jnp.asarray(z[None, :])))[0] for z in Zc])
    np.testing.assert_array_equal(batched, per_row)
    seen0 = {jchem.canonical_string(jchem.decode_tokens(t)) for t in per_row[:5]}
    bo._seen = set(seen0)
    toks, ys = bo._take_new(batched, 4)
    want, seen = [], set(seen0)
    for t in per_row:  # hebo_tpu/latent/chem.py's walk
        s = jchem.canonical_string(jchem.decode_tokens(t))
        if s in seen:
            continue
        seen.add(s)
        want.append(t)
        if len(want) >= 4:
            break
    np.testing.assert_array_equal(np.stack(toks), np.stack(want))
    assert ys == [jchem.penalized_logp_proxy(jchem.decode_tokens(t)) for t in want]
    assert bo._seen == seen


# ------------------------------------------------------------ LatentSpaceBO
class _FixedPop:
    def __init__(self, Z, F):
        self.Z, self.F = Z, F

    def optimize(self, **kw):
        return self.Z.copy(), self.F.copy()


class _NoFit:
    def fit(self, *a):
        return self


@pytest.mark.parametrize("specs", [CONT, CATS], ids=["continuous", "categorical"])
def test_latent_bo_decode_and_dedupe_equal_the_reference_picks(specs):
    """A carried VAE state, the same history and the same acquisition
    population: the port's suggestions equal the JAX package's."""
    kw = dict(latent_dim=3, retrain_every=64, n_init=4, vae_hidden=16)
    jo = jlbo.LatentSpaceBO(JSpace(specs), **kw)
    to = tlbo.LatentSpaceBO(DesignSpace(specs), device="cpu", **kw)
    to.vae_params = vae_from_flax(jax.tree.map(np.asarray, jo.vae_params), to.vae)
    hist = jo.space.sample(10, seed=1)
    y = np.random.default_rng(2).standard_normal((10, 1))
    jo.observe(hist, y)
    to.observe(hist, y)
    Zh = jo._encode(jo.space.transform(hist))
    np.testing.assert_allclose(to._encode(to.space.transform(hist)), Zh, rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(3)
    Z = np.vstack([Zh[:6], rng.standard_normal((42, 3)) * 1.5]).astype(np.float32)
    F = rng.standard_normal((48, 1)).astype(np.float32)
    F[:6] = -10.0  # the history's own encodings first
    for o in (jo, to):
        o._n_retrains, o.gp, o._evo = 1, _NoFit(), _FixedPop(Z, F)
    rj, rt = jo.suggest(5), to.suggest(5)
    assert rt.shape == (5, len(specs))
    if specs is CATS:
        assert rt.equals(rj)
    else:
        np.testing.assert_allclose(rt.values.astype(float), rj.values.astype(float), rtol=1e-5, atol=1e-5)


# -------------------------------------------- the JAX package's loop tests
def _quad(df):
    X = df.values.astype(float)
    return np.sum(X[:, :2] ** 2, axis=1, keepdims=True)


def test_latent_bo_runs():
    opt = tlbo.LatentSpaceBO(DesignSpace(CONT), latent_dim=3, retrain_every=6, n_init=6,
                             vae_steps=50, model_config={"num_epochs": 8}, device="cpu")
    for _ in range(6):
        rec = opt.suggest(3)
        assert rec.shape == (3, 8)
        opt.observe(rec, _quad(rec))
    assert np.isfinite(opt.best_y)
    assert opt._n_retrains >= 1


def test_latent_bo_categorical_sequences():
    def f(df):
        return -np.stack([(df[f"c{i}"].values == "a") for i in range(6)]).sum(0).astype(float).reshape(-1, 1)

    opt = tlbo.LatentSpaceBO(DesignSpace(CATS), latent_dim=3, retrain_every=6, n_init=6,
                             vae_steps=50, model_config={"num_epochs": 8}, device="cpu")
    for _ in range(4):
        rec = opt.suggest(2)
        opt.observe(rec, f(rec))
    assert np.isfinite(opt.best_y)


def test_latent_bo_semi_supervised():
    space = DesignSpace(CONT)
    opt = tlbo.LatentSpaceBO(space, latent_dim=3, retrain_every=6, n_init=6,
                             vae_steps=50, model_config={"num_epochs": 8}, device="cpu")
    opt.add_unlabeled(space.sample(32, seed=7))
    assert opt._unlabeled.shape == (32, 8)
    for _ in range(5):
        rec = opt.suggest(3)
        assert rec.shape == (3, 8)
        opt.observe(rec, _quad(rec))
    assert opt._n_retrains >= 1
    assert np.isfinite(opt.best_y)


def test_image_latent_bo_smoke():
    H = W = 16
    target = np.zeros((H, W), np.float32)
    target[6:10, :] = 1.0

    def score(imgs):
        b = (imgs[..., 0] > 0.5).astype(np.float32)
        return np.mean((b - target[None]) ** 2, axis=(1, 2)).reshape(-1, 1)

    bo = tdec.ImageLatentBO(image_hw=(H, W), latent_dim=4, vae_steps=20, retrain_every=3,
                            model_config={"num_epochs": 10}, device="cpu")
    ys = []
    for _ in range(8):
        imgs = bo.suggest(2)
        assert imgs.shape == (2, H, W, 1)
        assert imgs.min() >= 0.0 and imgs.max() <= 1.0
        y = score(imgs)
        bo.observe(imgs, y)
        ys.extend(y[:, 0].tolist())
    assert np.all(np.isfinite(ys))
    assert len(bo.retrain_time) >= 1


def test_image_latent_bo_keeps_the_references_retrain_rule():
    """The VAE retrains when ``_n_suggests % retrain_every == 1``, as in
    the JAX package (decoders.py:353): with ``retrain_every=1`` never."""
    bo = tdec.ImageLatentBO(image_hw=(8, 8), latent_dim=2, vae_steps=2, retrain_every=1,
                            model_config={"num_epochs": 2}, device="cpu")
    for _ in range(6):
        imgs = bo.suggest(1)
        bo.observe(imgs, imgs.reshape(1, -1).mean(1, keepdims=True))
    assert bo.retrain_time == [] and len(bo.fit_time) == 2


def test_chem_latent_bo_improves():
    bo = tchem.ChemLatentBO(n_init=48, vae_steps=60, retrain_every=3, seed=1, seq_len=16,
                            latent_dim=6, device="cpu")
    y0 = bo.best_y
    for _ in range(4):
        bo.step(batch=3)
    assert bo.best_y >= y0
    assert np.isfinite(bo.best_y)
    strs = [tchem.canonical_string(tchem.decode_tokens(t)) for t in bo.tokens]
    assert len(strs) - len(set(strs)) <= len(bo.tokens) // 4  # BO additions are unique
    assert len(bo.tokens) > 48
