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
  steps or its left-looking flow tasks; K1b's doubling levels of W or its
  forward-substitution flow tasks; the fused route's interleaved ticket
  order of both), checked here before the kernels run on a card.

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
    _fused_flow_tasks, _schedule_plain, _tile_factor_plain, chol_factor, chol_factor_inv,
    chol_factor_inv_plain, chol_factor_plain, chol_inv, chol_winv, chol_winv_plain, factor_inv,
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
    """nt = 4, 5, 7, 16 and 1 tiles: ragged last tiles, and the identity
    padding holds in L and in W."""
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


@pytest.mark.parametrize("B,N", [(1, 700), (1, 1000), (2, 448)])
def test_winv_flow_schedule_mirror_matches_slab_interpret(B, N):
    """K1b's flow route (row-order tasks, the depth summed in four quarters,
    the last term last, then the product with Wd_i), mirrored in plain
    torch on K1a's flow factor, against the JAX package's slab kernels
    (interpret mode) and the plain version; N 700 and the batch of 2 at 448
    cut the last tile, whose identity padding stays exact in W."""
    rng = np.random.default_rng(30 + N)
    K = _spd(rng, B, N)
    L, Wd, W = _schedule_plain(torch.as_tensor(K), route="flow")
    for b in range(B):  # identity-padded (exact) to a size the tests above have compiled
        Kp = np.eye(1024, dtype=np.float32)
        Kp[:N, :N] = K[b]
        Wj = np.asarray(chol_inv_slab(jnp.asarray(Kp[None]), interpret=True)[1])[0, :N, :N]
        np.testing.assert_allclose(W[b, :N, :N].numpy(), Wj, atol=1e-4)
    np.testing.assert_allclose(W.numpy(), chol_winv(L, Wd).numpy(), atol=1e-4)
    assert np.abs(np.triu(W.numpy(), 1)).max() == 0.0
    Np = padded_size(N)
    np.testing.assert_array_equal(W[:, N:, N:].numpy(), np.broadcast_to(np.eye(Np - N), (B, Np - N, Np - N)))
    np.testing.assert_array_equal(W[:, N:, :N].numpy(), 0.0)


def test_winv_flow_schedule_mirror_nan_in_late_tile():
    """The late-tile case on K1b's flow schedule: blockdiag(SPD 200×200,
    −I) fails first in tile 3 of 4; W is NaN in that matrix from there on
    and its neighbours' W is the plain version's."""
    rng = np.random.default_rng(12)
    K = _spd(rng, 3, 256)
    K[1, :200, 200:] = 0.0
    K[1, 200:, :200] = 0.0
    K[1, 200:, 200:] = -np.eye(56, dtype=np.float32)
    L, Wd, W = _schedule_plain(torch.as_tensor(K), route="flow")
    assert torch.isfinite(W[1, :192]).all()
    assert not torch.isfinite(W[1, 192:]).all()
    assert torch.isfinite(W[[0, 2]]).all()
    W0 = chol_winv(L[[0, 2]].contiguous(), Wd[[0, 2]].contiguous())
    np.testing.assert_allclose(W[[0, 2]].numpy(), W0.numpy(), atol=1e-4)


def test_winv_flow_schedule_out_of_order_reads_zeros(monkeypatch):
    """The flow mirror's order is what makes it right: rows taken last to
    first, every task (i, k) runs before the tasks that form W_jk, k < j < i,
    reads those tiles as zeros and gives −Wd_i L_ik Wd_k alone."""
    K = torch.as_tensor(_spd(np.random.default_rng(31), 1, 320))
    L, Wd, W = _schedule_plain(K, route="flow")
    nt = W.shape[-1] // 64
    monkeypatch.setattr(chol_kernel, "_winv_flow_tasks",
                        lambda n: [(i, k) for i in reversed(range(n)) for k in range(i + 1)])
    _, _, Wbad = _schedule_plain(K, route="flow")
    t = lambda i: slice(64 * i, 64 * (i + 1))
    for i in range(nt):
        for k in range(i):
            want = -(Wd[:, i] @ L[:, t(i), t(k)] @ Wd[:, k])
            np.testing.assert_allclose(Wbad[:, t(i), t(k)].numpy(), want.numpy(), atol=1e-5)
    np.testing.assert_allclose(Wbad[:, t(1), t(0)].numpy(), W[:, t(1), t(0)].numpy(), atol=1e-5)
    assert (Wbad - W).abs().max().item() > 1e-2


def _fused_reads_and_forms(kind, i, k):
    """The tiles a task of the fused order reads and forms: ("L", i, j),
    ("S", k + 1, k) the subdiagonal task's stored sum, ("Wd", k), ("W", i, k)."""
    if kind == "W":
        if i == k:
            return [("Wd", i)], [("W", i, i)]
        reads = [("L", i, j) for j in range(k, i)] + [("W", j, k) for j in range(k + 1, i)]
        return reads + [("Wd", k), ("Wd", i)], [("W", i, k)]
    if i == k:
        reads = [("L", k, j) for j in range(k - 1)]
        if k > 0:
            reads += [("S", k, k - 1), ("Wd", k - 1)]
        return reads, [("L", k, k - 1)] * (k > 0) + [("L", k, k), ("Wd", k)]
    reads = [t for j in range(k) for t in (("L", i, j), ("L", k, j))]
    if i == k + 1:
        return reads, [("S", i, k)]
    return reads + [("Wd", k)], [("L", i, k)]


@pytest.mark.parametrize("nt", range(8, 21))
def test_fused_flow_order_reads_only_formed_tiles(nt):
    """The fused route's ticket order (``csrc/chol.cu::fused_ticket``): each
    task of K1a's and of W's once, K1a's in their own order, W's rows in
    order, and every tile a task reads formed by a task with a smaller
    ticket, so that a task waits only on tasks that running CTAs hold."""
    order = _fused_flow_tasks(nt)
    assert len(order) == len(set(order)) == nt * (nt + 1)
    assert [(i, k) for kind, i, k in order if kind == "L"] == chol_kernel._flow_tasks(nt)
    assert [(i, k) for kind, i, k in order if kind == "W"] == chol_kernel._winv_flow_tasks(nt)
    formed = {}
    for ticket, (kind, i, k) in enumerate(order):
        for tile in _fused_reads_and_forms(kind, i, k)[1]:
            formed[tile] = ticket
    for ticket, (kind, i, k) in enumerate(order):
        for tile in _fused_reads_and_forms(kind, i, k)[0]:
            assert formed[tile] < ticket, (nt, kind, i, k, tile)
    # W's row w comes WINV_LAG columns of K1a's tasks after its diagonal task
    first = {i: t for t, (kind, i, k) in enumerate(order) if kind == "W" and k == 0}
    diag = {i: t for t, (kind, i, k) in enumerate(order) if kind == "L" and i == k}
    assert all(first[w] > diag[w] for w in range(nt))


def test_fused_schedule_mirror_matches_slab_interpret():
    """The fused route's order mirrored in plain torch (K1a's flow tasks and
    W's tasks interleaved, each with its own arithmetic) at N 700 (11 tiles)
    with a member whose first bad pivot lies in tile 9 (blockdiag(SPD
    600×600, −I)): the same bits as the flow mirror's L, Wd and W; the SPD
    member against the JAX package's slab kernels in interpret mode within
    1e-4 (float32, other summation orders); NaN in the bad member's L and W
    from tile 9 on and in no other member."""
    rng = np.random.default_rng(40)
    N, m = 700, 600
    K = _spd(rng, 2, N)
    K[1] = np.eye(N, dtype=np.float32)
    K[1, :m, :m] = _spd(rng, 1, m)[0]
    K[1, m:, m:] = -np.eye(N - m, dtype=np.float32)
    L, Wd, W = _schedule_plain(torch.as_tensor(K), route="fused")
    Lf, Wdf, Wf = _schedule_plain(torch.as_tensor(K), route="flow")
    for a, b in ((L, Lf), (Wd, Wdf), (W, Wf)):
        assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    Kp = np.eye(1024, dtype=np.float32)  # identity-padded (exact) to a size the tests above compiled
    Kp[:N, :N] = K[0]
    Lj, Wj = (np.asarray(t)[0, :N, :N] for t in chol_inv_slab(jnp.asarray(Kp[None]), interpret=True))
    np.testing.assert_allclose(L[0, :N, :N].numpy(), Lj, atol=1e-4)
    np.testing.assert_allclose(W[0, :N, :N].numpy(), Wj, atol=1e-4)
    assert torch.isfinite(L[0]).all() and torch.isfinite(W[0]).all()
    assert torch.isfinite(L[1, :576]).all() and torch.isfinite(W[1, :576]).all()
    assert not torch.isfinite(L[1, 576:]).all() and not torch.isfinite(W[1, 576:]).all()


def test_chol_factor_inv_on_cpu_is_the_plain_pair():
    """``chol_factor_inv`` on CPU tensors is ``chol_factor_plain`` then
    ``chol_winv_plain``, with jitter, skip and out; ``factor_inv`` on CPU
    tensors takes the pair at any size."""
    rng = np.random.default_rng(41)
    K = torch.as_tensor(_spd(rng, 3, 130))
    jitter = torch.tensor([1e-3, 0.5, 0.25])
    skip = torch.tensor([0, 1, 0], dtype=torch.int32)
    L0, Wd0 = chol_factor_plain(K, jitter)
    W0 = chol_winv_plain(L0, Wd0)
    for fn in (chol_factor_inv, chol_factor_inv_plain, factor_inv):
        L, Wd, W = fn(K, jitter)
        assert torch.equal(L, L0) and torch.equal(Wd, Wd0) and torch.equal(W, W0)
        out = (torch.full_like(L0, 7.0), torch.full_like(Wd0, 7.0), torch.full_like(W0, 7.0))
        got = fn(K, jitter, skip, out=out)
        assert all(g is o for g, o in zip(got, out))
        assert all(bool((o[1] == 7).all()) for o in out)
        for o, want in zip(out, (L0, Wd0, W0)):
            assert torch.equal(o[[0, 2]], want[[0, 2]])
    with pytest.raises(ValueError, match="out"):
        chol_factor_inv(K, jitter, skip)
    with pytest.raises(ValueError, match="out shapes"):
        chol_factor_inv(K, out=(L0, Wd0, Wd0))


def test_winv_schedule_mirror_one_tile_is_the_copy():
    """At one tile (N ≤ 64) K1b's route is the copy W = Wd: the mirror gives
    Wd's bits, with the identity padding exact, and the wrapper on CPU
    tensors the plain version."""
    K = torch.as_tensor(_spd(np.random.default_rng(15), 3, 40))
    L, Wd, W = _schedule_plain(K)
    assert torch.equal(W, Wd[:, 0])
    np.testing.assert_array_equal(W[:, 40:, 40:].numpy(), np.broadcast_to(np.eye(24), (3, 24, 24)))
    L0, Wd0 = chol_factor_plain(K)
    np.testing.assert_allclose(W.numpy(), chol_winv(L0, Wd0).numpy(), atol=1e-4)


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
