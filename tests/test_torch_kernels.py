"""hebo_tpu_torch kernel modules against hebo_tpu's Pallas kernels.

K2 (``ops/gram.py``) and K1 (``ops/chol_kernel.py``) run their plain
PyTorch versions on CPU tensors; the JAX side runs the Pallas kernels in
interpret mode, as hebo_tpu's own tests do.  The same numpy inputs go to
both.

Tolerances (float32 on both sides, different summation orders):
* Gram: rtol 1e-5, atol 1e-6; its gradient: rtol 1e-4, atol 1e-5.
* (L, W): 1e-4 absolute on well-conditioned SPD inputs (diagonal ≥ 0.5).
  The same for ``_schedule_plain``, the plain mirror of the CUDA kernels'
  block schedule (16-wide sub-blocked tile factor; K1a's look-ahead panel
  steps or its left-looking flow tasks; doubling levels of W), checked here
  before the kernels run on a card.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.ops.pallas_chol import chol_inv_slab
from hebo_tpu.ops.pallas_gram import matern32_gram as jax_gram
from hebo_tpu.models.gp import kernels as jkernels
from hebo_tpu.ops.pallas_gram import matern32_gram_reference
from hebo_tpu_torch.models.gp import kernels as tkernels
from hebo_tpu_torch.ops import chol_kernel
from hebo_tpu_torch.ops.chol_kernel import (
    _schedule_plain, _tile_factor_plain, chol_factor, chol_factor_plain, chol_inv, chol_winv,
    padded_size,
)
from hebo_tpu_torch.ops.gram import matern32_gram


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(rng, B, N):
    A = rng.normal(size=(B, N, N)).astype(np.float32)
    return A @ np.transpose(A, (0, 2, 1)) / N + 0.5 * np.eye(N, dtype=np.float32)


@pytest.mark.parametrize("N,M,D", [(70, 45, 5), (128, 100, 6)])
def test_gram_matches_pallas_interpret(N, M, D):
    rng = np.random.default_rng(0)
    x1 = rng.standard_normal((N, D)).astype(np.float32)
    x2 = rng.standard_normal((M, D)).astype(np.float32)
    ls = rng.uniform(0.5, 2.0, D).astype(np.float32)
    Kj = np.asarray(jax_gram(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls),
                             outputscale=1.7, interpret=True))
    a = torch.as_tensor(x1 / ls)[None]
    b = torch.as_tensor(x2 / ls)[None]
    Kt = matern32_gram(a, b, torch.tensor([1.7]))[0].numpy()
    np.testing.assert_allclose(Kt, Kj, rtol=1e-5, atol=1e-6)


def test_kernel_helpers_match():
    """sq_dist, matern32 and embed_categorical of models/gp/kernels.py."""
    rng = np.random.default_rng(9)
    x1 = rng.standard_normal((12, 3)).astype(np.float32)
    x2 = rng.standard_normal((7, 3)).astype(np.float32)
    ls = np.asarray([0.5, 1.0, 2.0], np.float32)
    np.testing.assert_allclose(tkernels.sq_dist(torch.as_tensor(x1), torch.as_tensor(x2)).numpy(),
                               np.asarray(jkernels.sq_dist(jnp.asarray(x1), jnp.asarray(x2))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tkernels.matern32(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(ls)).numpy(),
        np.asarray(jkernels.matern32(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls))),
        rtol=1e-5, atol=1e-6)
    codes = rng.integers(0, [3, 5], (9, 2)).astype(np.float32)
    table = rng.standard_normal((8, 4)).astype(np.float32)
    offs = np.asarray([0, 3], np.int32)
    want = jkernels.embed_categorical(jnp.asarray(codes), jnp.asarray(table), jnp.asarray(offs),
                                      jnp.asarray([3, 5], jnp.int32))
    got = tkernels.embed_categorical(torch.as_tensor(codes), torch.as_tensor(table), torch.as_tensor(offs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gram_jitter_on_global_diagonal():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((2, 33, 3)).astype(np.float32))
    sc = torch.tensor([1.0, 2.0])
    K = matern32_gram(x, x, sc, jitter=0.25)
    K0 = matern32_gram(x, x, sc)
    eye = torch.eye(33)
    np.testing.assert_allclose((K - K0).numpy(), (0.25 * eye).expand(2, 33, 33).numpy(),
                               atol=1e-6)


def test_gram_gradient_matches_jax_vjp():
    rng = np.random.default_rng(2)
    x1 = rng.standard_normal((20, 4)).astype(np.float32)
    x2 = rng.standard_normal((15, 4)).astype(np.float32)
    ls = rng.uniform(0.5, 2.0, 4).astype(np.float32)
    g = rng.standard_normal((20, 15)).astype(np.float32)

    def jf(a, b, l, s):
        return jnp.sum(s * matern32_gram_reference(a, b, l) * g)

    ja, jb, jl, js = jax.grad(jf, argnums=(0, 1, 2, 3))(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls), jnp.float32(1.3))
    t1, t2, tl, ts = (torch.tensor(v, requires_grad=True) for v in (x1, x2, ls, [1.3]))
    K = matern32_gram((t1 / tl)[None], (t2 / tl)[None], ts)[0]
    (K * torch.as_tensor(g)).sum().backward()
    for got, want in ((t1, ja), (t2, jb), (tl, jl)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy()[0], float(js), rtol=1e-4)


@pytest.mark.parametrize("B,N", [(2, 128), (3, 256)])
def test_chol_inv_matches_slab_interpret(B, N):
    rng = np.random.default_rng(3)
    K = _spd(rng, B, N)
    Lj, Wj = (np.asarray(t) for t in chol_inv_slab(jnp.asarray(K), interpret=True))
    L, W = (t.numpy() for t in chol_inv(torch.as_tensor(K)))
    np.testing.assert_allclose(L, Lj, atol=1e-4)
    np.testing.assert_allclose(W, Wj, atol=1e-4)
    assert np.abs(np.triu(L, 1)).max() == 0.0 and np.abs(np.triu(W, 1)).max() == 0.0


@pytest.mark.parametrize("N", [8, 40, 64, 100, 384])
def test_chol_inv_any_bucket_size(N):
    """Identity padding to the 64-tile is exact: every bucket size works."""
    rng = np.random.default_rng(4)
    K = _spd(rng, 2, N)
    L, W = (t.numpy().astype(np.float64) for t in chol_inv(torch.as_tensor(K)))
    assert L.shape == W.shape == (2, N, N)
    np.testing.assert_allclose(L, np.linalg.cholesky(K.astype(np.float64)), atol=1e-4)
    np.testing.assert_allclose(W @ L, np.broadcast_to(np.eye(N), (2, N, N)), atol=1e-4)
    Lp, Wd = chol_factor(torch.as_tensor(K))
    assert Lp.shape[-1] == padded_size(N) and Lp.shape[-1] % chol_kernel.TILE == 0
    assert Wd.shape == (2, padded_size(N) // 64, 64, 64)


def test_chol_nan_propagation_stays_in_its_matrix():
    """A non-PSD member yields NaNs (where cholesky_ex alone would give a
    finite wrong factor); its batch neighbours are untouched."""
    rng = np.random.default_rng(5)
    K = _spd(rng, 3, 128)
    K[1] = -np.eye(128, dtype=np.float32)
    L, W = chol_inv(torch.as_tensor(K))
    assert not torch.isfinite(L[1]).all() and not torch.isfinite(W[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(W[[0, 2]]).all()
    Lj, _ = chol_inv_slab(jnp.asarray(K), interpret=True)
    np.testing.assert_allclose(L[[0, 2]].numpy(), np.asarray(Lj)[[0, 2]], atol=1e-4)
    # the 2x2 case of the port's notes: finite factor + info from cholesky_ex
    K2 = torch.tensor([[[1.0, 2.0], [2.0, 1.0]]])
    assert torch.isfinite(torch.linalg.cholesky_ex(K2)[0]).all()
    assert not torch.isfinite(chol_inv(K2)[0]).all()


@pytest.mark.parametrize("B,N", [(2, 128), (1, 384), (1, 1024)])
def test_schedule_mirror_matches_slab_interpret(B, N):
    """The CUDA block schedule, mirrored in plain torch, against the JAX
    package's slab kernels (interpret mode) and the plain version."""
    rng = np.random.default_rng(10 + N)
    K = _spd(rng, B, N)
    L, Wd, W = (t.numpy() for t in _schedule_plain(torch.as_tensor(K)))
    Lj, Wj = (np.asarray(t) for t in chol_inv_slab(jnp.asarray(K), interpret=True))
    np.testing.assert_allclose(L, Lj, atol=1e-4)
    np.testing.assert_allclose(W, Wj, atol=1e-4)
    assert np.abs(np.triu(L, 1)).max() == 0.0 and np.abs(np.triu(W, 1)).max() == 0.0
    L0, Wd0 = chol_factor_plain(torch.as_tensor(K))
    np.testing.assert_allclose(Wd, Wd0.numpy(), atol=1e-4)


@pytest.mark.parametrize("B,N", [(3, 200), (1, 320), (2, 448), (1, 1000), (2, 40)])
def test_schedule_mirror_ragged_tile_counts(B, N):
    """nt = 4, 5, 7, 16 and 1 tiles: the doubling's second block is cut at
    nt, and the identity padding holds at every level."""
    rng = np.random.default_rng(N)
    K = _spd(rng, B, N)
    L, Wd, W = _schedule_plain(torch.as_tensor(K))
    L0, Wd0 = chol_factor_plain(torch.as_tensor(K))
    np.testing.assert_allclose(L.numpy(), L0.numpy(), atol=1e-4)
    np.testing.assert_allclose(Wd.numpy(), Wd0.numpy(), atol=1e-4)
    np.testing.assert_allclose(W.numpy(), chol_winv(L0, Wd0).numpy(), atol=1e-4)
    Np = padded_size(N)
    np.testing.assert_allclose(W[:, N:, N:].numpy(), np.broadcast_to(np.eye(Np - N), (B, Np - N, Np - N)),
                               atol=0)


def test_tile_factor_mirror():
    """The 16-sub-blocked tile factor: L and L⁻¹ of one 64×64 tile against
    float64 LAPACK, and NaN from a pivot that is not > 0 in its last block."""
    rng = np.random.default_rng(11)
    K = _spd(rng, 2, 64)
    K[1, 50:, 50:] -= 4.0 * np.eye(14, dtype=np.float32)
    L, X = _tile_factor_plain(torch.as_tensor(K))
    L64 = np.linalg.cholesky(K[0].astype(np.float64))
    np.testing.assert_allclose(L[0].numpy(), L64, atol=1e-5)
    np.testing.assert_allclose(X[0].numpy(), np.linalg.inv(L64), atol=1e-4)
    assert torch.isfinite(L[1, :50]).all() and not torch.isfinite(L[1]).all()
    assert not torch.isfinite(X[1]).all()


def test_schedule_mirror_nan_in_late_tile():
    """blockdiag(SPD 200×200, −I): the first bad pivot is in tile 3 of 4;
    the NaN reaches that matrix's L and W and no neighbour's."""
    rng = np.random.default_rng(12)
    K = _spd(rng, 3, 256)
    K[1, :200, 200:] = 0.0
    K[1, 200:, :200] = 0.0
    K[1, 200:, 200:] = -np.eye(56, dtype=np.float32)
    L, Wd, W = _schedule_plain(torch.as_tensor(K))
    assert torch.isfinite(L[1, :192]).all()
    assert not torch.isfinite(L[1]).all() and not torch.isfinite(W[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(W[[0, 2]]).all()
    L0, _ = chol_factor_plain(torch.as_tensor(K))
    np.testing.assert_allclose(L[[0, 2]].numpy(), L0[[0, 2]].numpy(), atol=1e-4)
    assert not torch.isfinite(chol_inv(torch.as_tensor(K))[0][1]).all()


@pytest.mark.parametrize("B,N", [(1, 384), (1, 1000), (1, 700), (2, 448)])
def test_flow_schedule_mirror_matches_slab_interpret(B, N):
    """K1a's flow route (left-looking tasks, the depth summed in four
    quarters, the subdiagonal tile formed by the diagonal task), mirrored in
    plain torch, against the JAX package's slab kernels (interpret mode) and
    the plain version; N 700 and the batch of 2 at 448 cut the last tile."""
    rng = np.random.default_rng(20 + N)
    K = _spd(rng, B, N)
    L, Wd, W = (t.numpy() for t in _schedule_plain(torch.as_tensor(K), route="flow"))
    # the slab kernel takes N in multiples of 128: each member goes alone,
    # identity-padded (exact) to a size the tests above have compiled
    size = 384 if N <= 384 else 1024
    for b in range(B):
        Kp = np.eye(size, dtype=np.float32)
        Kp[:N, :N] = K[b]
        Lj, Wj = (np.asarray(t)[0, :N, :N] for t in chol_inv_slab(jnp.asarray(Kp[None]), interpret=True))
        np.testing.assert_allclose(L[b, :N, :N], Lj, atol=1e-4)
        np.testing.assert_allclose(W[b, :N, :N], Wj, atol=1e-4)
    assert np.abs(np.triu(L, 1)).max() == 0.0 and np.abs(np.triu(W, 1)).max() == 0.0
    L0, Wd0 = chol_factor_plain(torch.as_tensor(K))
    np.testing.assert_allclose(L, L0.numpy(), atol=1e-4)
    np.testing.assert_allclose(Wd, Wd0.numpy(), atol=1e-4)
    Np = padded_size(N)
    np.testing.assert_array_equal(L[:, N:, N:], np.broadcast_to(np.eye(Np - N), (B, Np - N, Np - N)))


def test_flow_schedule_mirror_nan_in_late_tile():
    """The late-tile case of ``test_schedule_mirror_nan_in_late_tile`` on
    the flow schedule: blockdiag(SPD 200×200, −I) fails first in tile 3 of
    4; the NaN reaches that matrix's L and W and no neighbour's."""
    rng = np.random.default_rng(12)
    K = _spd(rng, 3, 256)
    K[1, :200, 200:] = 0.0
    K[1, 200:, :200] = 0.0
    K[1, 200:, 200:] = -np.eye(56, dtype=np.float32)
    L, Wd, W = _schedule_plain(torch.as_tensor(K), route="flow")
    assert torch.isfinite(L[1, :192]).all()
    assert not torch.isfinite(L[1]).all() and not torch.isfinite(W[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(W[[0, 2]]).all()
    L0, _ = chol_factor_plain(torch.as_tensor(K))
    np.testing.assert_allclose(L[[0, 2]].numpy(), L0[[0, 2]].numpy(), atol=1e-4)


def test_chol_factor_route_argument():
    """``route`` names one of K1a's routes; on CPU tensors either gives the
    plain version, and another name is refused."""
    K = torch.as_tensor(_spd(np.random.default_rng(14), 2, 100))
    L0, Wd0 = chol_factor_plain(K)
    for r in chol_kernel.ROUTES:
        L, Wd = chol_factor(K, route=r)
        assert torch.equal(L, L0) and torch.equal(Wd, Wd0)
    with pytest.raises(ValueError, match="route"):
        chol_factor(K, route="panel")
    with pytest.raises(ValueError, match="route"):
        _schedule_plain(K, route="panel")


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(ValueError):
        matern32_gram(meta, meta, torch.zeros(1, device="meta"))
    with pytest.raises(ValueError):
        chol_winv(meta, torch.zeros((1, 1, 64, 64), device="meta"))


# K4: hebo_tpu's r3 resident-kernel API (pallas_chol.py:243/:249), served by K1
@pytest.mark.parametrize("B,N", [(3, 128), (2, 256)])
def test_cholesky_batched_api_matches_pallas_interpret(B, N):
    from hebo_tpu.ops.pallas_chol import cholesky_batched as jchol

    rng = np.random.default_rng(0)
    A = rng.standard_normal((B, N, 32)).astype(np.float32)
    K = A @ np.swapaxes(A, 1, 2) + 32.0 * np.eye(N, dtype=np.float32)
    Lj = np.asarray(jchol(jnp.asarray(K), interpret=True))
    L = chol_kernel.cholesky_batched(torch.as_tensor(K)).numpy()
    assert L.shape == (B, N, N)
    assert np.abs(L - Lj).max() / np.abs(Lj).max() < 2e-5
    iu = np.triu_indices(N, k=1)
    assert np.abs(L[:, iu[0], iu[1]]).max() == 0.0


def test_chol_inv_batched_api_matches_pallas_interpret():
    from hebo_tpu.ops.pallas_chol import chol_inv_batched as jchol_inv

    rng = np.random.default_rng(1)
    B, N = 2, 256
    A = rng.standard_normal((B, N, 16)).astype(np.float32)
    K = A @ np.swapaxes(A, 1, 2) + 16.0 * np.eye(N, dtype=np.float32)
    Lj, Wj = (np.asarray(t) for t in jchol_inv(jnp.asarray(K), interpret=True))
    L, W = (t.numpy() for t in chol_kernel.chol_inv_batched(torch.as_tensor(K)))
    np.testing.assert_allclose(L, Lj, rtol=0, atol=1e-4 * np.abs(Lj).max())
    assert np.abs(np.einsum("bij,bjk->bik", W, L) - np.eye(N)[None]).max() < 1e-3
    np.testing.assert_allclose(W, Wj, rtol=0, atol=1e-4)
    bad = np.diag([1.0, -1.0] + [1.0] * 126).astype(np.float32)[None]
    assert np.isnan(chol_kernel.cholesky_batched(torch.as_tensor(bad)).numpy()).any()
