"""SparsePO in hebo_tpu_torch (``po/sparsepo.py``) against hebo_tpu on CPU.

The flax ``TinyLM`` parameters are carried across (``tinylm_from_flax``)
and the same numpy-seeded tokens go through both packages.  Tolerances:
* ``TinyLM``'s logits and three mask outputs: 1e-5 of the largest |value|
  (float32), on weights perturbed by 0.1·N(0, 1): at flax's init every
  LayerNorm has unit scale and zero bias, so every hidden state's norm is
  √d to rounding and the MaPO ``activation`` statistic (the z-normed norm)
  is rounding noise in both packages;
* ``sparse_dpo_loss`` for each mask mode: 1e-5 (float32);
* three DPO steps with fed indices: in float64 (JAX with x64), every
  parameter within 1e-5 of max(its tensor's largest |value|, lr) and the
  losses within 1e-10.  In float32 the attention key biases are where Adam
  meets a gradient ≈ ε: softmax ignores a constant added to a row of logits,
  so their gradient is rounding (≈ 1e-9), which Adam's g / (√v + ε) turns
  into steps of either sign up to lr; the float32 losses are held at 1e-5.
The JAX package's own SparsePO tests run on the port at their sizes.
"""

import functools

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp
import optax

from hebo_tpu.po import sparsepo as jp
from hebo_tpu_torch.po import sparsepo as tp
from hebo_tpu_torch.po import TinyLM, make_pref_data, preference_accuracy, train_sparse_po

T = torch.as_tensor
MODES = ["learned", "all_layers", "activation", "common"]


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


def _close(a, b, tol, floor=1e-30, what=""):
    a = a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), floor), err_msg=what)


JM = jp.TinyLM(vocab=32, d_model=32, n_heads=2, n_layers=2, max_len=16)
_init = jax.jit(JM.init)


@pytest.fixture(scope="module")
def lm():
    """A flax TinyLM (2 layers, 2 heads, d 32), its init perturbed by
    0.1·N(0, 1), the port's model and the carried weights, and tokens."""
    jm = JM
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 32, (6, 12))
    p = _init(jax.random.PRNGKey(0), jnp.asarray(tok[:1]))
    leaves, tdef = jax.tree_util.tree_flatten(p)
    p = jax.tree_util.tree_unflatten(tdef, [np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
                                            for x in leaves])
    tm = TinyLM(32, 32, 2, 2, 16, device="cpu")
    return jm, p, tm, tp.tinylm_from_flax(p, tm), tok


def test_tinylm_forward_matches_reference(lm):
    jm, p, tm, tparams, tok = lm
    jl, jmask = jm.apply(p, jnp.asarray(tok))
    tl, tmask = functional_call(tm, tparams, (T(tok),))
    _close(tl, jl, 1e-5, what="logits")
    assert set(tmask) == set(jmask)
    for k in jmask:
        _close(tmask[k], jmask[k], 1e-5, what=k)


@pytest.mark.parametrize("mode", MODES)
def test_sparse_dpo_loss_matches_reference(lm, mode):
    jm, p, tm, tparams, tok = lm
    ref = jax.tree_util.tree_map(lambda a: 0.98 * a, p)  # another reference policy
    jl, jmm = jp.sparse_dpo_loss(jm, p, ref, jnp.asarray(tok[:3]), jnp.asarray(tok[3:]), mask_mode=mode)
    tl, tmm = tp.sparse_dpo_loss(tm, tparams, tp.tinylm_from_flax(ref, tm), T(tok[:3]), T(tok[3:]),
                                 mask_mode=mode)
    _close(tl, jl, 1e-5)
    _close(tmm, jmm, 1e-5)


def test_mask_heads_get_no_gradient_into_the_lm(lm):
    """flax's stop_gradient sites: the mask outputs depend on the mask
    heads' own parameters only."""
    _, _, tm, tparams, tok = lm
    cur = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    _, masks = functional_call(tm, cur, (T(tok),))
    grads = torch.autograd.grad(sum(m.sum() for m in masks.values()), list(cur.values()), allow_unused=True)
    heads = ("mask_head.", "mask_l.", "mask_ln.", "mask_mixer.")
    for (k, _), g in zip(cur.items(), grads):
        moved = g is not None and bool(g.abs().max() > 0)
        assert moved == k.startswith(heads), k


def _dpo_case(n=32, T_=12, n_steps=3, batch=8):
    rng = np.random.default_rng(1)
    chosen = rng.integers(4, 32, (n, T_))
    chosen[:, T_ // 2] = 3
    rejected = rng.integers(4, 32, (n, T_))
    return chosen, rejected, rng.integers(0, n, (n_steps, batch))


@functools.lru_cache(maxsize=None)
def _jax_step(mode):
    """``train_sparse_po``'s scan body as one jitted step, with the
    minibatch fed."""
    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, st, p0, c, r):
        (v, _), g = jax.value_and_grad(
            lambda pp: jp.sparse_dpo_loss(JM, pp, p0, c, r, mask_mode=mode), has_aux=True)(p)
        up, st = opt.update(g, st, p)
        return optax.apply_updates(p, up), st, v

    return opt, step


def _jax_steps(p0, chosen, rejected, idx, mode):
    opt, step = _jax_step(mode)
    st, p, losses = opt.init(p0), p0, []
    for i in idx:
        p, st, v = step(p, st, p0, jnp.asarray(chosen[i]), jnp.asarray(rejected[i]))
        losses.append(float(v))
    return p, np.asarray(losses)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("mode", MODES)
def test_dpo_steps_match_reference_in_float64(x64, mode):
    chosen, rejected, idx = _dpo_case()
    p0 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float64),
                                _init(jax.random.PRNGKey(0), jnp.asarray(chosen[:1])))
    pj, lj = _jax_steps(p0, chosen, rejected, idx, mode)
    tm = TinyLM(32, 32, 2, 2, 16, device="cpu").double()
    tm.load_state_dict(tp.tinylm_from_flax(p0, tm))
    pt, info = train_sparse_po(tm, T(chosen), T(rejected), n_steps=3, batch=8, mask_mode=mode, idx=idx)
    np.testing.assert_allclose(info["loss"], lj, rtol=0, atol=1e-10)
    for k, v in tp.tinylm_from_flax(pj, tm).items():
        _close(pt[k], v, 1e-5, floor=1e-3, what=k)


def test_dpo_step_losses_match_reference_in_float32():
    chosen, rejected, idx = _dpo_case()
    p0 = _init(jax.random.PRNGKey(0), jnp.asarray(chosen[:1]))
    _, lj = _jax_steps(p0, chosen, rejected, idx, "learned")
    tm = TinyLM(32, 32, 2, 2, 16, device="cpu")
    tm.load_state_dict(tp.tinylm_from_flax(p0, tm))
    _, info = train_sparse_po(tm, T(chosen), T(rejected), n_steps=3, batch=8, idx=idx)
    np.testing.assert_allclose(info["loss"], lj, rtol=1e-5)


def test_make_pref_data():
    c, r = make_pref_data(64, 12, 32, generator=torch.Generator().manual_seed(0), device="cpu")
    assert c.shape == r.shape == (64, 12) and c.dtype == torch.long
    assert (c[:, 6] == 3).all() and (r >= 4).all() and (r < 32).all()
    assert (c[:, :6] >= 4).all()


# ---------------------------- the JAX package's own tests, run on the port
def test_sparse_po_learns_preferences():
    g = torch.Generator().manual_seed(0)
    model = TinyLM(vocab=32, d_model=32, n_layers=1, max_len=16, generator=g, device="cpu")
    chosen, rejected = make_pref_data(64, 12, 32, generator=g, device="cpu")
    params, metrics = train_sparse_po(model, chosen, rejected, n_steps=120, batch=16, generator=g)
    assert np.isfinite(metrics["loss"]).all()
    # optimization reduces the DPO loss
    assert metrics["loss"][-10:].mean() < metrics["loss"][:10].mean()
    assert preference_accuracy(model, params, metrics["ref_params"], chosen, rejected) > 0.8
    # masks stay in (0,1) and the sparsity term keeps them below saturation
    assert 0.0 < metrics["mask_mean"][-1] < 1.0


def test_all_mask_flavors_train():
    g = torch.Generator().manual_seed(0)
    model = TinyLM(vocab=32, d_model=32, n_heads=2, n_layers=2, max_len=24, generator=g, device="cpu")
    chosen, rejected = make_pref_data(64, 24, 32, generator=g, device="cpu")
    for mode in MODES:
        params, info = train_sparse_po(model, chosen, rejected, n_steps=60, mask_mode=mode,
                                       generator=torch.Generator().manual_seed(1))
        acc = preference_accuracy(model, params, info["ref_params"], chosen, rejected, mask_mode=mode)
        assert acc > 0.6, (mode, acc)
        assert info["loss"][-1] < info["loss"][0], mode


def test_po_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TinyLM(32)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_pref_data(4, 8, 32)
