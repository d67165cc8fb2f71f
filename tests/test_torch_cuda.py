"""hebo_tpu_torch's CUDA kernels against their plain PyTorch versions, on the card.

Imports only torch and the port, so it runs where JAX is not installed:

    python3 -m pytest --noconftest -m gpu tests/test_torch_cuda.py

Without a CUDA device every test skips.  Tolerances: Gram 1e-5 (float32,
values ≤ outputscale); its VJP 1e-4 × the largest |value| of each plain
gradient (float32 sums over M or N terms in another order); L 1e-4 and W 1e-3 absolute on SPD inputs with
diagonal ≥ 0.5 (float32, blocked vs LAPACK summation order); on a GP-like
Matérn Gram the kernel's residual ‖W·L − I‖_max within 10× the plain
version's (W by doubling vs forward substitution); SSK raw totals
1e-5 and tangents 1e-4 relative, normalised SSK Gram 1e-5 absolute (prefix
recursions vs dense D-matrix products), on both of K3's routes.
"""

import numpy as np
import pytest
import torch

from hebo_tpu_torch.ops import chol_kernel, ssk
from hebo_tpu_torch.ops.chol_kernel import chol_inv
from hebo_tpu_torch.ops import gram
from hebo_tpu_torch.ops.gram import matern32_gram, matern32_gram_plain


def _spd(rng, B, N):
    A = rng.normal(size=(B, N, N)).astype(np.float32)
    return A @ np.transpose(A, (0, 2, 1)) / N + 0.5 * np.eye(N, dtype=np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 -m pytest --noconftest -m gpu tests/test_torch_cuda.py)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,D", [(2, 1024, 1024, 6), (1, 1024, 100, 6), (3, 70, 45, 40)])
def test_gram_kernel_on_card(cuda, B, N, M, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn((B, N, D), generator=g, device=cuda)
    b = torch.randn((B, M, D), generator=g, device=cuda)
    sc = torch.rand((B,), generator=g, device=cuda) + 0.5
    n0 = matern32_gram.launches
    K = matern32_gram(a, b, sc, jitter=1e-3)
    assert matern32_gram.launches == n0 + 1
    torch.testing.assert_close(K, matern32_gram_plain(a, b, sc, 1e-3), rtol=1e-5, atol=1e-5)


def _gram_inputs(cuda, B, N, M, D, seed=0):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32), device=cuda)
    sc = torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32), device=cuda)
    return t(B, N, D), t(B, M, D), sc, t(B, N, M)


def _assert_vjp_close(got, want):
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert (x - y).abs().max().item() <= 1e-4 * y.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,D", [
    (2, 1024, 1024, 6), (1, 1024, 1024, 6), (2, 128, 128, 6),  # fit and cache
    (1, 1024, 100, 6), (1, 128, 100, 6),                       # NSGA-II predict
    (2, 1000, 1000, 6), (2, 256, 256, 20),                     # ragged edge; D past one chunk
    (1, 100, 1, 6), (3, 70, 45, 6), (1, 37, 130, 6),           # M = 1, B = 3, ragged tiles
    (2, 90, 70, 1), (1, 90, 70, 16), (2, 70, 45, 17), (3, 70, 45, 40),
])
def test_gram_vjp_kernel_on_card(cuda, B, N, M, D):
    a, b, sc, g = _gram_inputs(cuda, B, N, M, D)
    n0 = gram.matern32_gram_vjp.launches
    got = gram.matern32_gram_vjp(a, b, sc, g)
    assert gram.matern32_gram_vjp.launches == n0 + 1
    _assert_vjp_close(got, gram.matern32_gram_vjp_plain(a, b, sc, g))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [128, 1024])
def test_gram_vjp_self_gram_coincident_rows(cuda, N):
    """A fit's self-Gram: repeated rows and the zero rows of a padded bucket."""
    a, _, sc, g = _gram_inputs(cuda, 2, N, N, 6, seed=1)
    a[:, N // 2: N // 2 + 8] = a[:, :8]
    a[:, -16:] = 0.0
    _assert_vjp_close(gram.matern32_gram_vjp(a, a, sc, g), gram.matern32_gram_vjp_plain(a, a, sc, g))


@pytest.mark.gpu
def test_gram_backward_goes_through_vjp_kernel(cuda):
    """One backward through ``matern32_gram`` on CUDA is one VJP wrapper
    call, and gives the plain closed form's gradients."""
    a, b, sc, g = _gram_inputs(cuda, 2, 128, 128, 6, seed=2)
    leaves = [t.clone().requires_grad_(True) for t in (a, b, sc)]
    K = matern32_gram(*leaves, jitter=1e-3)
    n0 = gram.matern32_gram_vjp.launches
    got = torch.autograd.grad(K, leaves, g)
    assert gram.matern32_gram_vjp.launches == n0 + 1
    _assert_vjp_close(got, gram.matern32_gram_vjp_plain(a, b, sc, g))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,D", [(2, 1024, 1024, 6), (1, 1000, 100, 20)])
def test_gram_vjp_same_bits_twice(cuda, B, N, M, D):
    """No float atomics: the same inputs give the same bits."""
    a, b, sc, g = _gram_inputs(cuda, B, N, M, D, seed=3)
    for x, y in zip(gram.matern32_gram_vjp(a, b, sc, g), gram.matern32_gram_vjp(a, b, sc, g)):
        assert torch.equal(x, y)


def _expected_rows(B, N, M, sms):
    """csrc/gram.cu::pick_rows: the largest tile (64 or 32 rows) that gives
    every SM a CTA, else 16 rows."""
    for rows in (64, 32):
        if B * -(-N // rows) * -(-M // 64) >= sms:
            return rows
    return 16


@pytest.mark.gpu
@pytest.mark.parametrize("rows,edge", [(64, 0), (32, 0), (32, 1), (16, 1)])
def test_gram_tile_rows_at_the_edges(cuda, rows, edge):
    """At the edge of each tile choice (one 64-column tile, N giving exactly
    one CTA per SM, or one row less), both kernels take the rule's rows and
    agree with their plain versions."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    N = (rows if edge == 0 else 2 * rows) * (sms - 1) + 1 - edge
    assert _expected_rows(1, N, 64, sms) == rows and gram.tile_rows(1, N, 64) == rows
    a, b, sc, g = _gram_inputs(cuda, 1, N, 64, 6, seed=4)
    torch.testing.assert_close(matern32_gram(a, b, sc, 1e-3), matern32_gram_plain(a, b, sc, 1e-3),
                               rtol=1e-5, atol=1e-5)
    _assert_vjp_close(gram.matern32_gram_vjp(a, b, sc, g), gram.matern32_gram_vjp_plain(a, b, sc, g))


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(2, 128), (2, 1024), (1, 1024), (2, 2048), (2, 40), (1, 384),
                                 (1, 32), (1, 256), (1, 1000), (3, 384)])
def test_chol_kernel_on_card(cuda, B, N):
    rng = np.random.default_rng(6)
    K = torch.as_tensor(_spd(rng, B, N), device=cuda)
    L, W = chol_inv(K)
    L0, W0 = chol_kernel.chol_inv(K.cpu())
    torch.testing.assert_close(L.cpu(), L0, rtol=0, atol=1e-4)
    torch.testing.assert_close(W.cpu(), W0, rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_chol_kernel_nan_stays_in_its_matrix(cuda):
    rng = np.random.default_rng(7)
    K = torch.as_tensor(_spd(rng, 3, 256), device=cuda)
    K[1] = -torch.eye(256, device=cuda)
    L, W = chol_inv(K)
    assert not torch.isfinite(L[1]).all() and not torch.isfinite(W[1]).all()
    assert torch.isfinite(L[[0, 2]]).all() and torch.isfinite(W[[0, 2]]).all()


@pytest.mark.gpu
def test_chol_kernel_nan_in_late_tile(cuda):
    """blockdiag(SPD 200×200, −I) in a batch of 3: the first bad pivot lies
    in tile 3 of 4, after two look-ahead steps; it must reach that matrix's
    L and W, and its neighbours must come out as if factored alone."""
    rng = np.random.default_rng(9)
    K = _spd(rng, 3, 256)
    K[1] = np.eye(256, dtype=np.float32)
    K[1, :200, :200] = _spd(rng, 1, 200)[0]
    K[1, 200:, 200:] = -np.eye(56, dtype=np.float32)
    Kc = torch.as_tensor(K, device=cuda)
    L, W = chol_inv(Kc)
    assert not torch.isfinite(L[1]).all() and not torch.isfinite(W[1]).all()
    assert torch.isfinite(L[1, :192]).all()
    for b in (0, 2):
        Lb, Wb = chol_inv(Kc[b:b + 1].contiguous())
        assert torch.equal(L[b], Lb[0]) and torch.equal(W[b], Wb[0])


@pytest.mark.gpu
@pytest.mark.parametrize("lengthscale", [0.3, 1.5])
def test_chol_kernel_gp_like_residual(cuda, lengthscale):
    """Matérn-3/2 Gram of 1024 Sobol points in 6-D, jitter 1e-6 × mean
    diagonal (condition number ~4e2 at lengthscale 0.3, ~5e5 at 1.5)."""
    from hebo_tpu_torch.ops.gram import matern32_gram_plain as gram_plain

    x = torch.quasirandom.SobolEngine(6, scramble=True, seed=0).draw(1024)[None] / lengthscale
    K = gram_plain(x, x, torch.ones(1), 0.0)
    K = (K + 1e-6 * K.diagonal(dim1=1, dim2=2).mean() * torch.eye(1024)).contiguous()
    eye = torch.eye(1024, dtype=torch.float64)
    L, W = chol_inv(K.to(cuda))
    L0, W0 = chol_kernel.chol_inv(K)
    res = (W.cpu().double() @ L.cpu().double() - eye).abs().max().item()
    res0 = (W0.double() @ L0.double() - eye).abs().max().item()
    assert np.isfinite(res) and res <= 10 * res0
    torch.testing.assert_close(L.cpu(), L0, rtol=0, atol=1e-4)


def _rel(a, b):
    return ((a - b).abs() / b.abs().clamp(min=1e-6)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,M,L,P,A,route", [
    (1, 256, 256, 11, 3, 20, "regs"),  # AntBO fit at bucket 256
    (2, 256, 256, 11, 3, 20, "regs"),  # B = 2, distinct decays
    (1, 256, 1, 11, 3, 20, "regs"),    # M = 1
    (1, 13, 5, 6, 2, 20, "regs"),
    (2, 37, 70, 4, 5, 20, "regs"),
    (1, 32, 32, 11, 3, 20, "regs"),    # AntBO bucket 32: the fit
    (1, 209, 32, 11, 3, 20, "regs"),   # AntBO bucket 32: one-flip neighbours
    (2, 40, 50, 13, 3, 20, "smem"),
    (1, 70, 80, 11, 3, 4, "regs"),     # L at the regs bound of P ≤ 3
    (1, 70, 80, 8, 5, 4, "regs"),      # L at the regs bound of P = 5
    (1, 70, 80, 1, 1, 4, "regs"),      # L = 1, P = 1
    (1, 70, 80, 12, 3, 4, "smem"),     # one column beyond the register budget
    (1, 70, 80, 9, 5, 4, "smem"),
    (1, 20, 30, 11, 6, 4, "smem"),     # P beyond the register budget
])
def test_ssk_kernel_on_card(cuda, B, N, M, L, P, A, route):
    """Codes from an alphabet of A letters (4: dense matches, every step of
    the DP non-zero).  The route the shape takes, one launch per wrapper
    call, both wrappers and the normalised Gram's decay gradients against
    the plain version."""
    rng = np.random.default_rng(B * N + M)
    s1 = torch.as_tensor(rng.integers(0, A, (N, L)), dtype=torch.int32, device=cuda)
    s2 = torch.as_tensor(rng.integers(0, A, (M, L)), dtype=torch.int32, device=cuda)
    md = torch.as_tensor(rng.uniform(0.3, 0.9, B), dtype=torch.float32, device=cuda)
    gd = torch.as_tensor(rng.uniform(0.3, 0.9, B), dtype=torch.float32, device=cuda)
    assert ssk.route(L, P) == route
    n0 = (ssk.ssk_cross.launches, ssk.ssk_self.launches)
    cross = ssk.ssk_cross(s1, s2, md * md, gd, P)
    self1 = ssk.ssk_self(s1, md * md, gd, P)
    assert (ssk.ssk_cross.launches, ssk.ssk_self.launches) == (n0[0] + 1, n0[1] + 1)
    cross0 = ssk.ssk_cross_plain(s1, s2, md * md, gd, P)
    self0 = ssk.ssk_self_plain(s1, md * md, gd, P)
    for k, tol in enumerate((1e-5, 1e-4, 1e-4)):
        assert _rel(cross[k], cross0[k]) <= tol
        assert _rel(self1[k], self0[k]) <= tol
    md.requires_grad_(True)
    gd.requires_grad_(True)
    K = ssk.ssk_gram(s1.float(), s2.float(), md, gd, P)
    K0 = ssk.ssk_gram_plain(s1, s2, md, gd, P)
    assert (K - K0).abs().max().item() <= 1e-5
    w = torch.randn(K.shape, device=cuda)
    g = torch.autograd.grad((w * K).sum(), (md, gd))
    g0 = torch.autograd.grad((w * K0).sum(), (md, gd))
    for a, b in zip(g, g0):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_chol_resident_api_on_card(cuda):
    rng = np.random.default_rng(8)
    K = torch.as_tensor(_spd(rng, 2, 512), device=cuda)
    L = chol_kernel.cholesky_batched(K)
    L2, W = chol_kernel.chol_inv_batched(K)
    L0, W0 = chol_kernel.chol_inv(K.cpu())
    torch.testing.assert_close(L.cpu(), L0, rtol=0, atol=1e-4)
    torch.testing.assert_close(L2.cpu(), L0, rtol=0, atol=1e-4)
    torch.testing.assert_close(W.cpu(), W0, rtol=0, atol=1e-3)
