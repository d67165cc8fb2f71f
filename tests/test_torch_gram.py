"""The VJP of kernel K2 (``hebo_tpu_torch/ops/gram.py``) against JAX's.

``matern32_gram_vjp_plain`` is the closed form that the CUDA VJP kernel
computes; here it is held against ``jax.vjp`` of the JAX package's
``matern32_gram_reference`` and against torch autograd of
``matern32_gram_plain``, on the same numpy inputs.  The port's Gram takes
inputs already scaled by 1/ℓ, so the gradients with respect to x1, x2 and
ℓ are carried through a = x1/ℓ, b = x2/ℓ by torch autograd.

Tolerance against JAX: rtol 1e-4, atol 1e-5.  Each gradient is a float32
sum over M (or N) terms taken in another order (the closed form a·ΣG − G·b
against autograd's chain through the norms and the matmul).  Against torch
autograd the comparison is in float64 (rtol 1e-9, atol 1e-10): autograd's
float32 d((1+s)e^{−s})/ds = e^{−s} − (1+s)e^{−s} keeps only ~eps/s of its
relative precision where a pair nearly coincides (s ~ 3e-4 for one pair at
D = 1 loses ~5e-4 absolute), which the closed form −s·e^{−s} does not.

The kernel itself is held against this plain form on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.ops.pallas_gram import matern32_gram_reference
from hebo_tpu_torch.ops.gram import (
    matern32_gram, matern32_gram_plain, matern32_gram_vjp, matern32_gram_vjp_plain,
)

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, N, M, D, duplicate=False):
    rng = np.random.default_rng(seed)
    x1 = rng.standard_normal((N, D)).astype(np.float32)
    x2 = rng.standard_normal((M, D)).astype(np.float32)
    if duplicate:
        # a self-Gram as the fit builds it: repeated rows and the zero rows
        # of a padded bucket give coincident pairs
        x1[N // 2: N // 2 + 5] = x1[:5]
        x1[-6:] = 0.0
        x2 = x1.copy()
    ls = rng.uniform(0.5, 2.0, D).astype(np.float32)
    g = rng.standard_normal((N, M)).astype(np.float32)
    return x1, x2, ls, np.float32(rng.uniform(0.5, 2.0)), g


def _jax_grads(x1, x2, ls, sc, g):
    _, vjp = jax.vjp(lambda a, b, l, s: s * matern32_gram_reference(a, b, l),
                     jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), jnp.float32(sc))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _port_grads(x1, x2, ls, sc, g, vjp):
    """(gx1, gx2, gℓ, gsc) from a VJP of the port's Gram in (a, b, sc)."""
    t1, t2, tl = (torch.tensor(v, requires_grad=True) for v in (x1, x2, ls))
    a, b = (t1 / tl)[None], (t2 / tl)[None]
    ga, gb, gsc = vjp(a.detach(), b.detach(), torch.tensor([sc]), torch.as_tensor(g)[None])
    grads = torch.autograd.grad([a, b], [t1, t2, tl], [ga, gb])
    return [t.numpy() for t in grads] + [gsc.numpy()[0]]


def _autograd_vjp(a, b, sc, g):
    leaves = [t.clone().requires_grad_(True) for t in (a, b, sc)]
    return torch.autograd.grad(matern32_gram_plain(*leaves), leaves, g)


CASES = [(20, 15, 4, False), (64, 64, 1, False), (37, 100, 17, False), (40, 40, 6, True)]


@pytest.mark.parametrize("N,M,D,duplicate", CASES)
def test_vjp_plain_matches_jax_vjp(N, M, D, duplicate):
    """Gradients in x1, x2, ℓ and the outputscale (≠ 1)."""
    inp = _inputs(N * M + D, N, M, D, duplicate)
    want = _jax_grads(*inp)
    got = _port_grads(*inp, matern32_gram_vjp_plain)
    for name, x, y in zip(("x1", "x2", "lengthscale", "outputscale"), got, want):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("N,M,D,duplicate", CASES)
def test_vjp_plain_matches_autograd_of_plain_form(N, M, D, duplicate):
    x1, x2, ls, sc, g = _inputs(N + M * D, N, M, D, duplicate)
    args = [torch.as_tensor(v, dtype=torch.float64)
            for v in ((x1 / ls)[None], (x2 / ls)[None], [sc], g[None])]
    for name, x, y in zip(("a", "b", "sc"), matern32_gram_vjp_plain(*args), _autograd_vjp(*args)):
        torch.testing.assert_close(x, y, rtol=1e-9, atol=1e-10, msg=name)


def test_vjp_plain_batched_matches_per_entry():
    """A batch of two (distinct sc, as the fit's two restarts) is two
    independent VJPs."""
    rng = np.random.default_rng(5)
    a, b = (torch.as_tensor(rng.standard_normal((2, n, 3)).astype(np.float32)) for n in (9, 7))
    sc = torch.tensor([0.7, 1.9])
    g = torch.as_tensor(rng.standard_normal((2, 9, 7)).astype(np.float32))
    whole = matern32_gram_vjp_plain(a, b, sc, g)
    for k in range(2):
        part = matern32_gram_vjp_plain(a[k:k + 1], b[k:k + 1], sc[k:k + 1], g[k:k + 1])
        for x, y in zip(whole, part):
            torch.testing.assert_close(x[k:k + 1], y, rtol=1e-6, atol=1e-7)


def test_cpu_backward_is_autograd_of_plain_form():
    """On CPU tensors ``matern32_gram`` is the plain form under autograd, as
    before the VJP kernel, and ``matern32_gram_vjp`` is the closed form."""
    x1, x2, ls, sc, g = _inputs(11, 33, 21, 5, False)
    args = (torch.as_tensor(x1 / ls)[None], torch.as_tensor(x2 / ls)[None], torch.tensor([sc]))
    gt = torch.as_tensor(g)[None]
    leaves = [t.clone().requires_grad_(True) for t in args]
    got = torch.autograd.grad(matern32_gram(*leaves, jitter=1e-3), leaves, gt)
    for x, y in zip(got, _autograd_vjp(*args, gt)):
        assert torch.equal(x, y)
    for x, y in zip(matern32_gram_vjp(*args, gt), matern32_gram_vjp_plain(*args, gt)):
        assert torch.equal(x, y)
