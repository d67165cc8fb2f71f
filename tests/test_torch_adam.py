"""The port's Adam step (``models/gp/tree.adam_step``, which every Adam of
hebo_tpu_torch goes through) against ``optax.adam`` on the CPU.

200 steps on seeded float32 gradients whose magnitudes spread over
1e-4..7 end within 1e-6 of optax's parameters: the bias corrections are
taken in float32 as optax takes them, and what is left is XLA fusing the
moment updates in another rounding order.  In float64 (JAX with x64) the
two agree to 1e-12.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hebo_tpu_torch.models.gp.tree import adam_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grads(n_steps, n, dtype):
    rng = np.random.default_rng(0)
    mag = 10.0 ** rng.uniform(-4, np.log10(7.0), size=(n_steps, n))
    return (rng.choice([-1.0, 1.0], size=(n_steps, n)) * mag).astype(dtype)


def _optax(p0, gs, lr):
    opt = optax.adam(lr)
    p, st = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    step = jax.jit(lambda p, st, g: (lambda u, s: (optax.apply_updates(p, u), s))(*opt.update(g, st, p)))
    for g in gs:
        p, st = step(p, st, jnp.asarray(g))
    return np.asarray(p)


def _port(p0, gs, lr):
    p = torch.as_tensor(p0)
    mu, nu = torch.zeros_like(p), torch.zeros_like(p)
    for i, g in enumerate(gs):
        p, mu, nu = adam_step(p, torch.as_tensor(g), mu, nu, i + 1, lr)
    return p.numpy()


@pytest.mark.parametrize("lr", [1e-3, 3e-2])
def test_adam_step_follows_optax_in_float32(lr):
    gs = _grads(200, 4096, np.float32)
    p0 = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    want, got = _optax(p0, gs, lr), _port(p0, gs, lr)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_adam_step_follows_optax_in_float64(x64):
    gs = _grads(50, 512, np.float64)
    p0 = np.random.default_rng(1).standard_normal(512)
    want = _optax(p0, gs, 3e-2)
    assert want.dtype == np.float64
    np.testing.assert_allclose(_port(p0, gs, 3e-2), want, rtol=0, atol=1e-12)
