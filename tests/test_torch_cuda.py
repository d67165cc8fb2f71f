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
recursions vs dense D-matrix products), on each of K3's routes.  K2's VJP
at its tiles' ragged edges.  K5 (rank,
crowding, NSGA-II key and survivor order) exactly: the same ranks, crowding
bits, keys and order as its plain version, NaN where NaN, and NSGA-II's
population after 20 generations through it the same as through the plain
version.  K1 with the ladder's jitter and skip: the same bits
as the ladder that adds the jitter before K1 and decides on the host; K1a
and K1b each on both of their routes (the rules' edges, both routes forced
at small sizes): the same tolerances, NaN confined to its matrix, a batch
member's bits equal to its own factorization's, and the same bits from two
launches; K1b's flow route at BOCS's (1, 5051) on a horseshoe-like
A = ΦᵀΦ + diag(1/(τ²λ²)): ‖W·L − I‖_max within 10× the plain version's.  HEBO's
suggest as a captured CUDA graph: the same suggestion as the eager CUDA path
at a seed, and a replay that makes no host sync.  Above max_cholesky_size:
the CG posterior against the dense K1 posterior at N = 2048 with
tests/test_cg.py's tolerances (μ 2e-2, σ² 5e-2 relative), a PCG solve and a
CG predict that make no host sync, TF32 off, and a valid large-N suggest.
The surrogate families: the deep ensemble's fit and predictions against
the CPU's from the same initial weights (1e-4 of the largest |value|),
NAP's task sampler through K1 (its y as close to a float64 factor as 10×
the CPU's float32 one), and the GBDT's forest against the CPU's with the
same draws (the same splits or a tie within rounding; leaves 1e-5).
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
@pytest.mark.parametrize("B,N,M,D", [(2, 1024, 1024, 6), (1, 1000, 100, 20), (32, 1024, 1024, 6),
                                     (1, 1000, 1000, 19)])
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
@pytest.mark.parametrize("B,N,M,D", [
    (2, 1024, 1024, 6), (4, 1024, 1024, 6), (32, 1024, 1024, 6),  # HEBO's fit; HMC / SVI; SMC
    (2, 2048, 2048, 6), (1, 1024, 1024, 8),                       # large-N fit; DKL
    (1, 1000, 1000, 6), (2, 1000, 1020, 6),   # N not a multiple of 64; M not either, M % 4 == 0
    (1, 1000, 1000, 19), (2, 300, 1102, 30),  # D past one chunk of 16 features; M % 4 != 0
    (1, 1000, 1000, 17), (4, 300, 600, 40),   # D one past a chunk; three chunks
    (2, 600, 700, 1), (1, 1000, 1000, 16),    # D = 1; D at one chunk
    (140, 70, 250, 5),                        # B 140, N and M ragged in every tile
    (2, 128, 128, 6), (1, 64, 8, 6), (1, 256, 256, 30),  # small grids
])
def test_gram_vjp_ragged_on_card(cuda, B, N, M, D):
    """One launch per call at tiles cut by N, M and D, the plain closed
    form's gradients, and the same bits from a second call."""
    a, b, sc, g = _gram_inputs(cuda, B, N, M, D, seed=5)
    n0 = gram.matern32_gram_vjp.launches
    got = gram.matern32_gram_vjp(a, b, sc, g)
    assert gram.matern32_gram_vjp.launches == n0 + 1
    _assert_vjp_close(got, gram.matern32_gram_vjp_plain(a, b, sc, g))
    for x, y in zip(gram.matern32_gram_vjp(a, b, sc, g), got):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(2, 128), (2, 1024), (1, 1024), (2, 2048), (2, 40), (1, 384),
                                 (1, 32), (1, 256), (1, 1000), (3, 384), (2, 2304), (2, 3072),
                                 (1, 5051), (1, 4096), (2, 448), (40, 1024)])
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
    (2, 40, 50, 13, 3, 20, "regs32/warp"),  # 4,000 pairs > 7·13²: regs32
    (1, 70, 80, 11, 3, 4, "regs"),     # L at the regs bound of P ≤ 3
    (1, 70, 80, 8, 5, 4, "regs"),      # L at the regs bound of P = 5
    (1, 70, 80, 1, 1, 4, "regs"),      # L = 1, P = 1
    (1, 70, 80, 12, 3, 4, "regs32/warp"),  # one column beyond the L 11 budget
    (1, 70, 80, 9, 5, 4, "smem"),
    (1, 20, 30, 11, 6, 4, "smem"),     # P beyond the register budget
    (1, 256, 256, 25, 3, 5, "regs32/warp"),  # BOSS / BOiLS: the fit at bucket 256
    (1, 256, 101, 25, 3, 5, "regs32/warp"),  # one-flip neighbours
    (1, 256, 8, 25, 3, 5, "warp"),           # the descents' queries
    (1, 125, 35, 25, 3, 5, "warp"),          # 4,375 = 7·25² pairs: the warp route's last count
    (1, 547, 8, 25, 3, 5, "regs32/warp"),    # 4,376 pairs: regs32
    (1, 70, 80, 16, 3, 4, "regs32/warp"),
    (1, 70, 80, 17, 3, 4, "regs32/warp"),
    (1, 70, 80, 32, 3, 4, "warp"),           # L at the regs32 bound; 5,600 ≤ 7·32² pairs
    (1, 100, 80, 32, 3, 4, "regs32/warp"),   # 8,000 pairs
    (1, 70, 80, 33, 3, 4, "smem"),           # one column beyond it: the general route
    (1, 70, 80, 20, 2, 4, "regs32/warp"),    # P = 2 on the long routes (P = 1: chip_smoke)
    (1, 70, 80, 14, 2, 4, "regs32/warp"),
])
def test_ssk_kernel_on_card(cuda, B, N, M, L, P, A, route):
    """Codes from an alphabet of A letters (4: dense matches, every step of
    the DP non-zero).  The route each launch takes ("cross/self" where the
    two differ: the warp route takes launches of at most 7·L² pairs), one
    launch per wrapper call, the same bits from a second launch on the same
    inputs, both wrappers against the plain version, and the normalised
    Gram's decay gradients against the plain version's for four seeded
    cotangents w.

    Each decay's gradient is a float32 sum of n = N·M terms t = w ⊙ ∂K/∂θ
    (with the chain factor 2·λ_m for the match decay), many of them
    cancelling.  Recursive summation of n terms errs by at most
    (n − 1)·ε·Σ|t| (ε = 2⁻²³), so the kernel's and the plain version's sums
    may differ by 2·(n − 1)·ε·Σ|t| (c = 2: one such bound for each side);
    the elementwise tangents are held at 1e-4 above.  Σ|t| is taken from the
    plain version's elementwise tangents."""
    rng = np.random.default_rng(B * N + M)
    s1 = torch.as_tensor(rng.integers(0, A, (N, L)), dtype=torch.int32, device=cuda)
    s2 = torch.as_tensor(rng.integers(0, A, (M, L)), dtype=torch.int32, device=cuda)
    md = torch.as_tensor(rng.uniform(0.3, 0.9, B), dtype=torch.float32, device=cuda)
    gd = torch.as_tensor(rng.uniform(0.3, 0.9, B), dtype=torch.float32, device=cuda)
    want_cross, _, want_self = route.partition("/")
    assert ssk.route(L, P, B * N * M) == want_cross
    assert ssk.route(L, P, B * N) == (want_self or want_cross)
    n0 = (ssk.ssk_cross.launches, ssk.ssk_self.launches)
    cross = ssk.ssk_cross(s1, s2, md * md, gd, P)
    self1 = ssk.ssk_self(s1, md * md, gd, P)
    assert (ssk.ssk_cross.launches, ssk.ssk_self.launches) == (n0[0] + 1, n0[1] + 1)
    cross0 = ssk.ssk_cross_plain(s1, s2, md * md, gd, P)
    self0 = ssk.ssk_self_plain(s1, md * md, gd, P)
    for again, first in ((ssk.ssk_cross(s1, s2, md * md, gd, P), cross),
                         (ssk.ssk_self(s1, md * md, gd, P), self1)):
        assert all(torch.equal(a, b) for a, b in zip(again, first))  # K3 sums in a fixed order
    for k, tol in enumerate((1e-5, 1e-4, 1e-4)):
        assert _rel(cross[k], cross0[k]) <= tol
        assert _rel(self1[k], self0[k]) <= tol
    md.requires_grad_(True)
    gd.requires_grad_(True)
    K = ssk.ssk_gram(s1.float(), s2.float(), md, gd, P)
    K0 = ssk.ssk_gram_plain(s1, s2, md, gd, P)
    assert (K - K0).abs().max().item() <= 1e-5
    _, dK_dl, dK_dg = ssk._normalise(cross0, self0, ssk.ssk_self_plain(s2, md * md, gd, P))
    n, eps = N * M, torch.finfo(torch.float32).eps
    for seed in range(4):
        w = torch.randn(K.shape, generator=torch.Generator(device=cuda).manual_seed(seed), device=cuda)
        g = torch.autograd.grad((w * K).sum(), (md, gd), retain_graph=True)
        g0 = torch.autograd.grad((w * K0).sum(), (md, gd), retain_graph=True)
        terms = ((w * dK_dl).abs().sum((-2, -1)) * 2 * md.detach(), (w * dK_dg).abs().sum((-2, -1)))
        for a, b, t in zip(g, g0, terms):
            assert ((a - b).abs() <= 2 * (n - 1) * eps * t).all(), (seed, a, b, t)


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


def _pareto_inputs(P, M, edge, seed, device, chain=False):
    """F (P, M) on a coarse grid (ties in every objective) with duplicate
    rows and, with ``edge``, ±inf and NaN entries; with ``chain``, row i is
    (r_i, ..., r_i) for a permutation r, so every point is its own front;
    with ``chain == "tail"`` (M = 2) the chain's last 100 points form one
    front on a line, crowded unevenly."""
    rng = np.random.default_rng(seed)
    if chain == "tail":
        n = P - 100
        t = rng.uniform(0, 100, 100)
        F = np.concatenate([np.repeat(rng.permutation(n)[:, None], 2, 1),
                            np.stack([n + t, n + 100 - t], 1)])[rng.permutation(P)]
        F = F.astype(np.float32)
    elif chain:
        F = np.repeat(rng.permutation(P).astype(np.float32)[:, None], M, 1)
    else:
        F = (rng.integers(0, 4 if edge else 1000, (P, M)) / 4).astype(np.float32)
        F[3 % P] = F[4 % P]
        F[10 % P] = F[11 % P] = F[12 % P]
    if edge:
        F[20 % P, 1 % M] = F[21 % P, 1 % M] = np.inf
        F[22 % P, 0] = -np.inf
        F[23 % P] = -np.inf
        F[30 % P, 2 % M] = np.nan
        F[31 % P] = np.nan
        F[40 % P] = ([np.inf, -np.inf, 0.5] * 2)[:M]
    return torch.as_tensor(F, device=device)


def _same_bits(a, b):
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and torch.equal(a[~nan].view(torch.int32),
                                                            b[~nan].view(torch.int32))


# chip_smoke's ``check_pareto`` shapes, the chain inputs, N = 1, 33 and 257
# (one word, one past it, one past the register peel) and, as P = 0, the
# largest N the wrapper admits at M = 3
_PARETO_SHAPES = ([(P, M, False) for P, M in
                   [(100, 3), (200, 3), (64, 1), (128, 1), (100, 1), (200, 1), (100, 2), (200, 2),
                    (100, 4), (200, 4), (48, 1), (96, 1), (32, 1), (48, 3), (96, 3), (1, 3), (33, 3),
                    (257, 3), (1, 1), (33, 1), (257, 1), (257, 2), (0, 3)]]
                  + [(200, 2, True), (200, 3, True)])


@pytest.mark.gpu
@pytest.mark.parametrize("P, M, chain", _PARETO_SHAPES)
@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_pareto_kernel_on_card(cuda, P, M, chain, edge, masked):
    """K5 against its plain version on the card and on the CPU at NSGA-II's
    shapes, the MCBO GA's single objective (where many points share a
    front), GeneralBO's M = 2 (ZDT1) and M = 4 (BNH: 2 objectives + 2
    constraints), chains of P fronts and the edges of the peel's layouts:
    ties, duplicate rows, ±inf and NaN objectives, invalid rows.  The rank,
    the crowding's bits, the NSGA-II key and the order of the first P // 2
    and of all P (``nsga2_select``), each one launch."""
    from hebo_tpu_torch.ops import pareto

    if P == 0:
        P = max(n for n in range(1, 4097) if pareto.fits(n, M))
        assert P >= 1184  # populations of up to 1184 points at M = 3 stay admitted
    F = _pareto_inputs(P, M, edge, P + edge, cuda, chain)
    valid = None
    if masked:
        valid = torch.as_tensor(np.random.default_rng(P).uniform(size=P) > 0.25, device=cuda)
    n0 = pareto.nsga2_rank_crowd.launches
    rank, crowd = pareto.nsga2_rank_crowd(F, valid)
    assert pareto.nsga2_rank_crowd.launches == n0 + 1
    r0, c0 = pareto.nsga2_rank_crowd_plain(F, valid)
    assert torch.equal(rank, r0) and _same_bits(crowd, c0)
    r1, c1 = pareto.nsga2_rank_crowd(F.cpu(), None if valid is None else valid.cpu())
    assert torch.equal(rank.cpu(), r1) and _same_bits(crowd, c1)
    assert torch.equal(pareto.nondominated_rank(F, valid), rank)
    if chain and not edge and not masked:
        assert int(rank.max()) == P - 1
    for n_keep in (P // 2, P):
        n0 = pareto.nsga2_rank_crowd.launches
        got = pareto.nsga2_select(F, n_keep, valid)
        assert pareto.nsga2_rank_crowd.launches == n0 + 1
        want = pareto.nsga2_select_plain(F, n_keep, valid)
        assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])
        assert torch.equal(got[2], want[2]) and got[3].dtype == torch.int64
        assert torch.equal(got[3], want[3])
        cpu = pareto.nsga2_select(F.cpu(), n_keep, None if valid is None else valid.cpu())
        assert torch.equal(got[2].cpu(), cpu[2]) and torch.equal(got[3].cpu(), cpu[3])
    assert pareto.nsga2_select(F, None, valid)[3] is None


# K5's grid route (P past the one-CTA route): (P, M, chain, edge, masked)
_GRID_CASES = [(1249, 3, False, True, False), (1260, 2, False, True, True),
               (1250, 4, False, False, True), (1400, 3, False, True, True),
               (4096, 3, False, False, False), (4200, 1, False, True, True),
               (4200, 2, True, False, False), (4200, 2, "tail", False, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("P, M, chain, edge, masked", _GRID_CASES)
def test_pareto_grid_route_on_card(cuda, P, M, chain, edge, masked):
    """K5's grid route against its plain version on the card: survival at
    MACE's pop 625 and 700, ZDT1's 630, BNH's 625, pop 2,048 at M = 3 and
    BO's M = 1 at pop 2,100, ties, ±inf and NaN objectives, invalid rows, a
    chain of 4,200 fronts and one with a crowded last front, whose keys pass
    2^24 and tie after rounding (so survival orders them by index, not by
    ordinal).  The rank, the crowding's bits, the key and every survivor's
    place, each call one launch of the wrapper, counted also as a grid-route launch."""
    from hebo_tpu_torch.ops import pareto

    assert pareto.route(P, M) == "grid" and not pareto.fits(P, M)
    F = _pareto_inputs(P, M, edge, P + edge, cuda, chain)
    valid = None
    if masked:
        valid = torch.as_tensor(np.random.default_rng(P).uniform(size=P) > 0.25, device=cuda)
    n0, g0 = pareto.nsga2_rank_crowd.launches, pareto.nsga2_rank_crowd.grid_launches
    rank, crowd = pareto.nsga2_rank_crowd(F, valid)
    assert (pareto.nsga2_rank_crowd.launches, pareto.nsga2_rank_crowd.grid_launches) == (n0 + 1, g0 + 1)
    want = pareto.nsga2_select_plain(F, P, valid)
    assert torch.equal(rank, want[0]) and _same_bits(crowd, want[1])
    got = pareto.nsga2_select(F, P, valid)
    assert pareto.nsga2_rank_crowd.grid_launches == g0 + 2
    assert torch.equal(got[0], want[0]) and _same_bits(got[1], want[1])
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
    assert torch.equal(pareto.nsga2_select(F, P // 2, valid)[3], want[3][:P // 2])
    if chain == "tail":  # the rounded keys tie: survival's order is not (rank, ordinal)'s
        keys = want[2].sort().values
        assert float(keys[-1]) > 2 ** 24 and bool((keys[1:] == keys[:-1]).any())
        c = torch.where(torch.isnan(want[1]), -float("inf"), want[1])
        ordinal = torch.argsort(torch.argsort(-c, stable=True), stable=True)
        assert not torch.equal(want[3], torch.argsort(want[0].long() * P + ordinal, stable=True))
    elif chain and not masked:
        assert int(rank.max()) == P - 1


@pytest.mark.gpu
def test_pareto_route_past_its_limit_raises(cuda):
    """Up to ``GRID_MAX_ROWS`` rows K5 has a route; past it the wrapper
    raises, naming the limit, and launches nothing."""
    from hebo_tpu_torch.ops import pareto

    assert pareto.route(pareto.GRID_MAX_ROWS, 4) == "grid"
    n0 = pareto.nsga2_rank_crowd.launches
    with pytest.raises(ValueError, match=f"at most {pareto.GRID_MAX_ROWS} rows"):
        pareto.nsga2_select(torch.zeros((pareto.GRID_MAX_ROWS + 1, 3), device=cuda), 10)
    assert pareto.nsga2_rank_crowd.launches == n0


@pytest.mark.gpu
def test_evolve_raw_with_kernel_equals_plain_on_card(cuda, monkeypatch):
    """NSGA-II at P 100 for 20 generations with fed draws: the population
    after the loop through K5 (keys and survivor order from its launches,
    no sort) equals, bit for bit, the loop with K5's plain version on the
    card (``nsga2_key`` and a stable argsort)."""
    from hebo_tpu_torch.acq_optimizers import evolution as evo
    from hebo_tpu_torch.ops import pareto

    P, D, n_gens = 100, 5, 20
    meta = evo.EvolveSpaceMeta(lb=(-2.0,) * 4 + (0.0,), ub=(2.0,) * 4 + (3.0,),
                               is_discrete=(False,) * 4 + (True,), is_cat=(False,) * 4 + (True,))
    g = torch.Generator(device=cuda).manual_seed(3)
    draws = [evo.draw_generation(P, D, g, cuda) for _ in range(n_gens)]
    init = torch.rand((P, D), generator=g, device=cuda) * 4 - 2

    def objectives(X):  # MACE-like: three objectives with ties from the rounded column
        return torch.stack([(X[:, :4] ** 2).sum(1) + X[:, 4], (X[:, :4] - 1).abs().sum(1),
                            -X[:, 0] * X[:, 4]], 1)

    n0 = pareto.nsga2_rank_crowd.launches
    X1, F1 = evo.evolve_raw(init, objectives, meta, n_gens=n_gens, draws=lambda i: draws[i])
    assert pareto.nsga2_rank_crowd.launches == n0 + 2 * n_gens
    monkeypatch.setattr(evo, "nsga2_select", pareto.nsga2_select_plain)
    X0, F0 = evo.evolve_raw(init, objectives, meta, n_gens=n_gens, draws=lambda i: draws[i])
    assert pareto.nsga2_rank_crowd.launches == n0 + 2 * n_gens
    assert torch.equal(X1, X0) and _same_bits(F1, F0)


def _ladder_on_host(Kt, rungs, base=1e-6):
    """The ladder as it was: K + jitter·I formed first, a retry only when
    the host sees a failure."""
    n = Kt.shape[-1]
    eye = torch.eye(n, device=Kt.device)
    scale = torch.clamp(torch.diagonal(Kt, dim1=-2, dim2=-1).mean(-1), min=1e-12)[:, None, None]
    L, W = chol_inv((Kt + (base + rungs[0] * scale) * eye).contiguous())
    ok = torch.isfinite(L).all(-1).all(-1)
    for rung in rungs[1:]:
        if bool(ok.all()):
            break
        L2, W2 = chol_inv((Kt + (base + rung * scale) * eye).contiguous())
        ok2 = torch.isfinite(L2).all(-1).all(-1)
        take = ((~ok) & ok2)[:, None, None]
        L, W, ok = torch.where(take, L2, L), torch.where(take, W2, W), ok | ok2
    return L, W, ok


@pytest.mark.gpu
@pytest.mark.parametrize("N", [40, 128, 300, 1024, 5051, 512])
def test_chol_ladder_skip_and_jitter_on_card(cuda, N):
    """K1 with the ladder's jitter and skip (every rung launched) against
    the host-decided ladder: a matrix that first factors at rung 2, one that
    fails every rung, one at rung 0; and a batch where all factor at rung 0."""
    from hebo_tpu_torch.ops import chol as tchol

    rng = np.random.default_rng(N)
    K = _spd(rng, 3, N)
    Q, _ = np.linalg.qr(rng.standard_normal((N, N)))
    d = rng.uniform(0.5, 1.0, N)
    d[0] = -2e-5
    K[0] = ((Q * d) @ Q.T).astype(np.float32)
    K[2] = -1e3 * np.eye(N, dtype=np.float32)
    for Kb, want in ((K, [True, True, False]), (_spd(rng, 2, N), [True, True])):
        Kt = torch.as_tensor(Kb, device=cuda)
        n0 = chol_kernel.chol_factor.launches
        L, W, ok = tchol.batched_ladder_factor(Kt, tchol.LADDER)
        assert chol_kernel.chol_factor.launches == n0 + len(tchol.LADDER)
        L0, W0, ok0 = _ladder_on_host(Kt, tchol.LADDER)
        assert ok.tolist() == ok0.tolist() == want
        assert torch.equal(L[ok], L0[ok0]) and torch.equal(W[ok], W0[ok0])
        for b in torch.nonzero(~ok).flatten().tolist():
            assert not torch.isfinite(L[b]).all() and not torch.isfinite(W[b]).all()
        Lc, Wc, okc = tchol.batched_ladder_factor(Kt.cpu(), tchol.LADDER)
        assert okc.tolist() == want
        torch.testing.assert_close(L[ok].cpu(), Lc[okc], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_chol_skip_keeps_out_on_card(cuda):
    rng = np.random.default_rng(12)
    K = torch.as_tensor(_spd(rng, 3, 200), device=cuda)
    Np = chol_kernel.padded_size(200)
    L = torch.full((3, Np, Np), 7.0, device=cuda)
    Wd = torch.full((3, Np // 64, 64, 64), 7.0, device=cuda)
    W = torch.full((3, Np, Np), 7.0, device=cuda)
    skip = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)
    jitter = torch.tensor([1e-3, 0.5, 0.25], device=cuda)
    chol_kernel.chol_factor(K, jitter, skip, out=(L, Wd))
    chol_kernel.chol_winv(L, Wd, skip, out=W)
    assert (L[1] == 7).all() and (Wd[1] == 7).all() and (W[1] == 7).all()
    for b in (0, 2):
        L0, Wd0 = chol_kernel.chol_factor((K[b:b + 1] + jitter[b] * torch.eye(200, device=cuda)).contiguous())
        assert torch.equal(L[b], L0[0]) and torch.equal(Wd[b], Wd0[0])
        assert torch.equal(W[b], chol_kernel.chol_winv(L0, Wd0)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,want", [(2, 448, "step"), (2, 512, "flow"), (1, 512, "flow"),
                                      (32, 1024, "flow"), (40, 1024, "flow"), (1, 5051, "flow"),
                                      (16, 32, "step"), (24, 256, "step")])
def test_chol_route_rule_on_card(cuda, B, N, want):
    """K1a's route at the rule's edge (8 tiles) and at batches, as
    csrc/chol.cu reports it, and both routes forced at the shape: the plain
    version's L and Wd within 1e-4, and the same bits from two launches."""
    assert chol_kernel.route(N) == want
    K = torch.as_tensor(_spd(np.random.default_rng(B * N), B, N), device=cuda)
    L0, Wd0 = chol_kernel.chol_factor_plain(K)
    for r in chol_kernel.ROUTES:
        L, Wd = chol_kernel.chol_factor(K, route=r)
        torch.testing.assert_close(L, L0, rtol=0, atol=1e-4)
        torch.testing.assert_close(Wd, Wd0, rtol=0, atol=1e-4)
        L2, Wd2 = chol_kernel.chol_factor(K, route=r)
        assert torch.equal(L, L2) and torch.equal(Wd, Wd2)


@pytest.mark.gpu
@pytest.mark.parametrize("B,N", [(3, 256), (3, 1100)])
def test_chol_flow_route_nan_on_card(cuda, B, N):
    """The flow route forced: a −I member and a member whose first bad pivot
    lies in a late tile (blockdiag(SPD, −I)) give NaN in their own L and W
    only, finite tiles before the bad one, and the other members the bits
    of their own factorization."""
    rng = np.random.default_rng(N)
    K = _spd(rng, B, N)
    K[0] = -np.eye(N, dtype=np.float32)
    m = N - 56
    K[1] = np.eye(N, dtype=np.float32)
    K[1, :m, :m] = _spd(rng, 1, m)[0]
    K[1, m:, m:] = -np.eye(56, dtype=np.float32)
    Kc = torch.as_tensor(K, device=cuda)
    L, Wd = chol_kernel.chol_factor(Kc, route="flow")
    W = chol_kernel.chol_winv(L, Wd)
    for b in (0, 1):
        assert not torch.isfinite(L[b]).all() and not torch.isfinite(W[b]).all()
    assert torch.isfinite(L[1, :m // 64 * 64]).all()
    Lb, Wdb = chol_kernel.chol_factor(Kc[2:3].contiguous(), route="flow")
    assert torch.equal(L[2], Lb[0]) and torch.equal(Wd[2], Wdb[0])
    assert torch.isfinite(W[2]).all()


@pytest.mark.gpu
def test_chol_flow_route_skip_keeps_out_on_card(cuda):
    """The flow route forced with the ladder's arguments: a skipped member
    keeps its buffers, the others the bits of K + jitter·I factored alone."""
    rng = np.random.default_rng(13)
    K = torch.as_tensor(_spd(rng, 3, 1000), device=cuda)
    Np = chol_kernel.padded_size(1000)
    L = torch.full((3, Np, Np), 7.0, device=cuda)
    Wd = torch.full((3, Np // 64, 64, 64), 7.0, device=cuda)
    skip = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)
    jitter = torch.tensor([1e-3, 0.5, 0.25], device=cuda)
    chol_kernel.chol_factor(K, jitter, skip, out=(L, Wd), route="flow")
    assert (L[1] == 7).all() and (Wd[1] == 7).all()
    for b in (0, 2):
        Kb = (K[b:b + 1] + jitter[b] * torch.eye(1000, device=cuda)).contiguous()
        L0, Wd0 = chol_kernel.chol_factor(Kb, route="flow")
        assert torch.equal(L[b], L0[0]) and torch.equal(Wd[b], Wd0[0])


@pytest.mark.gpu
@pytest.mark.parametrize("B,N,want", [(1, 64, "copy"), (16, 32, "copy"), (1, 65, "flow"), (2, 128, "flow"),
                                      (24, 256, "flow"), (2, 448, "flow"), (2, 512, "flow"),
                                      (32, 1024, "flow"), (40, 1024, "flow"), (1, 5051, "flow"),
                                      (1, 1100, "flow")])
def test_chol_winv_route_rule_on_card(cuda, B, N, want):
    """K1b's route at the rule's edge (2 tiles) and at batches, as
    csrc/chol.cu reports it: the plain version's W within 1e-3, the same
    bits from two launches, and at one tile the copy, Wd's bits."""
    assert chol_kernel.winv_route(N) == want
    K = torch.as_tensor(_spd(np.random.default_rng(B * N + 1), B, N), device=cuda)
    L, Wd = chol_kernel.chol_factor(K)
    W = chol_kernel.chol_winv(L, Wd)
    torch.testing.assert_close(W, chol_kernel.chol_winv_plain(L, Wd), rtol=0, atol=1e-3)
    assert torch.equal(W, chol_kernel.chol_winv(L, Wd))
    if want == "copy":
        assert torch.equal(W, Wd[:, 0])


@pytest.mark.gpu
def test_chol_winv_flow_skip_keeps_out_on_card(cuda):
    """K1b's flow route (N 1000) with the ladder's skip: a skipped member
    keeps its W, the others the bits of their own W alone."""
    assert chol_kernel.winv_route(1000) == "flow"
    K = torch.as_tensor(_spd(np.random.default_rng(14), 3, 1000), device=cuda)
    L, Wd = chol_kernel.chol_factor(K)
    W = torch.full_like(L, 7.0)
    skip = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)
    chol_kernel.chol_winv(L, Wd, skip, out=W)
    assert (W[1] == 7).all()
    for b in (0, 2):
        Wb = chol_kernel.chol_winv(L[b:b + 1].contiguous(), Wd[b:b + 1].contiguous())
        assert torch.equal(W[b], Wb[0])


@pytest.mark.gpu
def test_chol_winv_flow_nan_stays_in_its_matrix_on_card(cuda):
    """K1b's flow route (N 1100) on K1a's flow factor of a −I member and a
    member whose first bad pivot lies in its last tile: NaN in their W from
    that tile on, finite before it, and the third member the bits of its
    own W alone."""
    rng = np.random.default_rng(15)
    N, m = 1100, 1044
    K = _spd(rng, 3, N)
    K[0] = -np.eye(N, dtype=np.float32)
    K[1] = np.eye(N, dtype=np.float32)
    K[1, :m, :m] = _spd(rng, 1, m)[0]
    K[1, m:, m:] = -np.eye(N - m, dtype=np.float32)
    L, Wd = chol_kernel.chol_factor(torch.as_tensor(K, device=cuda), route="flow")
    assert chol_kernel.winv_route(N) == "flow"
    W = chol_kernel.chol_winv(L, Wd)
    assert not torch.isfinite(W[0]).all() and not torch.isfinite(W[1]).all()
    assert torch.isfinite(W[1, :m // 64 * 64]).all()
    assert torch.isfinite(W[2]).all()
    W2 = chol_kernel.chol_winv(L[2:3].contiguous(), Wd[2:3].contiguous())
    assert torch.equal(W[2], W2[0])


@pytest.mark.gpu
def test_chol_winv_bocs_like_residual_on_card(cuda):
    """BOCS's Gibbs sweep at (1, 5051): A = ΦᵀΦ + diag(1/(τ²λ²)) with Φ the
    200 × 5051 quadratic features of pest control's 25 stations × 5
    choices (intercept, 4 dummies a station, their pairwise products), λ²
    from the horseshoe's inverse-gamma (capped at 10, τ² = 1).  K1b's flow
    route: ‖W·L − I‖_max within 10× the plain version's (solve_triangular
    on the same L), in float64."""
    rng = np.random.default_rng(16)
    choice = rng.integers(0, 5, (200, 25))
    X = np.concatenate([(choice == c).astype(np.float32) for c in range(1, 5)], 1)
    iu = np.triu_indices(100, 1)
    Phi = np.concatenate([np.ones((200, 1), np.float32), X, X[:, iu[0]] * X[:, iu[1]]], 1)
    assert Phi.shape == (200, 5051)
    lam2 = np.minimum(1.0 / rng.gamma(1.0, 1.0, 5051), 10.0)
    P = torch.as_tensor(Phi, device=cuda)
    A = (P.T @ P + torch.diag(torch.as_tensor(1.0 / lam2, dtype=torch.float32, device=cuda)))
    L, Wd = chol_kernel.chol_factor(A[None].contiguous())
    assert torch.isfinite(L).all()
    assert chol_kernel.winv_route(5051) == "flow"
    W = chol_kernel.chol_winv(L, Wd)
    W0 = chol_kernel.chol_winv_plain(L, Wd)
    eye = torch.eye(L.shape[-1], dtype=torch.float64, device=cuda)
    res = (W[0].double() @ L[0].double() - eye).abs().max().item()
    res0 = (W0[0].double() @ L[0].double() - eye).abs().max().item()
    assert np.isfinite(res) and res <= 10 * res0


def _ackley(df):
    X = df[[f"x{i}" for i in range(6)]].values.astype(float)
    s1 = (X ** 2).mean(1) ** 0.5
    s2 = np.cos(2 * np.pi * X).mean(1)
    return (-20.0 * np.exp(-0.2 * s1) - np.exp(s2) + 20.0 + np.e).reshape(-1, 1)


@pytest.mark.gpu
def test_hebo_graph_suggest_equals_eager_and_never_syncs(cuda):
    """HEBO at full defaults, bucket 128: the captured graph's suggestion
    equals the eager CUDA path's at the same seed; its launch tally gives
    50 K2 VJP launches a suggest; a replay (inputs, draws, graph) runs under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    import pandas as pd

    from hebo_tpu_torch import HEBO, DesignSpace
    from hebo_tpu_torch.optimizers.hebo import COUNTED

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = HEBO(space, device="cuda")
    warm = space.inverse_transform(space.sobol_sample_opt(112, seed=1))
    opt.observe(warm, _ackley(warm))
    rec_g = opt.suggest(8)  # captures bucket 128
    assert list(opt._graphs) and list(opt._graphs)[0][0] == 128
    alpha_g = opt.model.caches.alpha.clone()
    n0 = gram.matern32_gram_vjp.launches
    assert opt.suggest(8).equals(rec_g)  # a replay gives the same again
    assert gram.matern32_gram_vjp.launches == n0 + 50
    opt._use_graphs = False
    rec_e = opt.suggest(8)
    pd.testing.assert_frame_equal(rec_g, rec_e)
    assert torch.equal(opt.model.caches.alpha, alpha_g)
    opt._use_graphs = True

    Xv = space.transform(opt.X).astype(np.float32)
    n_pad, meta, host = opt._suggest_inputs(Xv, opt.y.astype(np.float32), 2.0, None)
    counts = {w: w.launches for w in COUNTED}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = opt._device_suggest(n_pad, meta, host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out).all()
    assert all(w.launches > counts[w] for w in COUNTED)


@pytest.mark.gpu
def test_hebo_pop_700_graph_suggest_on_card(cuda):
    """``HEBO(space, pop=700)``: survival ranks 1,400 rows, past K5's one-CTA
    route, so each generation's survival takes the grid route inside the
    fused graph.  A suggest(8) through the captured graph, whose replay adds
    100 grid launches, equals the eager CUDA path's at the same seed, and is
    finite, in the box and of the asked size."""
    from hebo_tpu_torch import HEBO, DesignSpace
    from hebo_tpu_torch.ops import pareto

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = HEBO(space, pop=700, device="cuda")
    warm = space.inverse_transform(space.sobol_sample_opt(112, seed=1))
    opt.observe(warm, _ackley(warm))
    rec_g = opt.suggest(8)  # captures bucket 128
    assert [k[0] for k in opt._graphs] == [128]
    g0 = pareto.nsga2_rank_crowd.grid_launches
    assert opt.suggest(8).equals(rec_g)
    assert pareto.nsga2_rank_crowd.grid_launches == g0 + opt.iters
    opt._use_graphs = False
    pd_rec = opt.suggest(8)
    opt._use_graphs = True
    assert pd_rec.equals(rec_g)
    X = space.transform(rec_g)
    assert X.shape == (8, 6) and np.isfinite(X).all()
    assert (X >= space.opt_lb).all() and (X <= space.opt_ub).all()


def _zdt1(df):
    X = df[[f"x{i}" for i in range(30)]].values.astype(float)
    g = 1.0 + 9.0 * X[:, 1:].sum(1) / 29.0
    return np.stack([X[:, 0], g * (1.0 - np.sqrt(X[:, 0] / g))], 1)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["general_bo_zdt1_pop_640", "bo_single_objective_pop_2100"])
def test_large_population_suggest_on_card(cuda, case):
    """``GeneralBO`` on ZDT1 (M = 2) at pop 640 (survival at 1,280 rows) and
    ``BO`` at M = 1 at pop 2,100 (4,200 rows): one model suggest each, on
    K5's grid route, gives valid, new points of the asked size."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.ops import pareto
    from hebo_tpu_torch.optimizers import BO, GeneralBO

    if case.startswith("general"):
        space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": 0.0, "ub": 1.0}
                             for i in range(30)])
        opt = GeneralBO(space, num_obj=2, pop=640, iters=10, model_config={"num_epochs": 8},
                        device="cuda")
        f, n, warm = _zdt1, 4, 40
    else:
        space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                             for i in range(6)])
        opt = BO(space, pop=2100, iters=10, device="cuda")
        f, n, warm = _ackley, 1, 20
    X0 = space.inverse_transform(space.sobol_sample_opt(warm, seed=1))
    opt.observe(X0, f(X0))
    g0 = pareto.nsga2_rank_crowd.grid_launches
    rec = opt.suggest(n)
    assert pareto.nsga2_rank_crowd.grid_launches >= g0 + 10
    X = space.transform(rec)
    assert X.shape == (n, space.num_cols) and np.isfinite(X).all()
    assert (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
    seen = {tuple(r) for r in space.transform(X0)}
    assert len({tuple(r) for r in X} - seen) == n


def _gp_2048(cuda):
    """tests/test_cg.py's setup at N = 2048: a dense GP fitted on the card,
    and its samples' posterior rebuilt through CG (max_cholesky_size 1024)."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.models.gp.gp import GP

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -3.0, "ub": 3.0} for i in range(4)])
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (2048, 4)).astype(np.float32)
    y = (np.sin(X[:, :1]) + 0.1 * X[:, 1:2] ** 2).astype(np.float32)
    kw = dict(num_epochs=15, n_restarts=1, seed=7)
    dense = GP(space, device="cuda", **kw).fit(X, y)
    cg = GP(space, device="cuda", max_cholesky_size=1024, cg_rank=96, cg_iters=128, **kw)
    cg.data, cg.samples, cg.params = dense.data, dense.samples, dense.params
    cg.caches = cg.core.posterior_cache_batched(dense.samples, dense.data)
    return dense, cg, rng.uniform(-3, 3, (100, 4)).astype(np.float32)


@pytest.mark.gpu
def test_cg_posterior_matches_dense_on_card(cuda):
    """CG (pivoted-Cholesky preconditioner, block PCG) against the dense K1
    posterior of the same samples at N = 2048, with tests/test_cg.py's
    tolerances: μ rtol / atol 2e-2, σ² rtol 5e-2 / atol 2e-2."""
    dense, cg, Xq = _gp_2048(cuda)
    assert dense.caches.Wf is not None and cg.caches.Kt is not None
    assert bool(cg.caches.ok.all()) and float(cg.caches.res.max()) < 0.2
    mu_d, v_d = dense.predict(Xq)
    mu_c, v_c = cg.predict(Xq)
    np.testing.assert_allclose(mu_c, mu_d, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(v_c, v_d, rtol=5e-2, atol=2e-2)
    # that atol is the size of σ² itself here: the converged solve also
    # within 1e-3 of the largest |μ| and 1e-2 of the largest σ²
    assert np.abs(mu_c - mu_d).max() <= 1e-3 * np.abs(mu_d).max()
    assert np.abs(v_c - v_d).max() <= 1e-2 * v_d.max()


@pytest.mark.gpu
def test_posterior_ladder_above_bucket_2048_on_card(cuda):
    """max_cholesky_size 4096 at N = 2300 (bucket 2304): the fit and the
    posterior run the K1 ladder.  α, μ and σ² of the card's cache and of
    the plain version's cache on the CPU (the same samples and data) are
    held against float64 solves of the same system: the card's error
    within 10× the plain version's (α and μ relative to their largest
    value, σ² to the prior variance)."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.models.gp.gp import GP
    from hebo_tpu_torch.ops import chol_kernel as ck

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -3.0, "ub": 3.0} for i in range(4)])
    rng = np.random.default_rng(1)
    X = rng.uniform(-3, 3, (2300, 4)).astype(np.float32)
    y = (np.sin(X[:, :1]) + 0.1 * X[:, 1:2] ** 2 + 0.05 * rng.standard_normal((2300, 1))).astype(np.float32)
    Xq = torch.as_tensor(rng.uniform(-3, 3, (50, 4)).astype(np.float32))
    before = ck.chol_factor.launches
    gp = GP(space, device="cuda", max_cholesky_size=4096, num_epochs=5, n_restarts=1, seed=2).fit(X, y)
    assert ck.chol_factor.launches > before and gp.data.X.shape[0] == 2304 and gp.fit_data is gp.data
    core, cache = gp.core, gp.caches
    assert cache.Kt is None and cache.Wf is not None and bool(cache.ok.all())
    cpu = lambda t: type(t)(*[None if v is None else v.cpu() for v in t])
    samples, data = cpu(gp.samples), cpu(gp.data)
    ref = core.posterior_cache_batched(samples, data)
    np.testing.assert_array_equal(cache.ok.cpu().numpy(), ref.ok.numpy())
    with torch.no_grad():
        mu, var = core.predict_scaled(gp.samples, cache, gp.data, Xq.to(cuda))
        mu0, var0 = core.predict_scaled(samples, ref, data, Xq)
        Kt, r = core._train_system(samples, data)
        Ks = (core.gram_points(samples, data.X, Xq, data) * data.mask.to(Kt.dtype)[:, None]).double()
    K64 = Kt.double()
    a64 = torch.linalg.solve(K64, r.double())
    kss = torch.exp(samples.log_sc.double())
    mu64 = samples.mean.double()[:, None, None] + Ks.transpose(-1, -2) @ a64
    var64 = (kss[:, None] - (Ks * torch.linalg.solve(K64, Ks)).sum(-2))[..., None]
    err = lambda x, want, scale: float((x.cpu().double() - want).abs().max() / scale)
    for name, card, plain, want, scale in (
            ("alpha", cache.alpha, ref.alpha, a64, a64.abs().max()),
            ("mu", mu, mu0, mu64, mu64.abs().max()), ("var", var, var0, var64, kss.max())):
        e, e0 = err(card, want, scale), err(plain, want, scale)
        assert e <= 10 * e0 + 1e-6, f"{name}: card error {e:.3g}, plain version's {e0:.3g}"


@pytest.mark.gpu
def test_cg_path_never_syncs_and_runs_without_tf32(cuda):
    """One ``pcg_solve`` and one CG ``predict_scaled`` under
    ``set_sync_debug_mode("error")``: the fixed-count loop reads nothing on
    the host.  TF32 is off on this path (the GP's device set it), and
    ``pcg_solve`` refuses to run with it on."""
    from hebo_tpu_torch.ops.cg import pcg_solve, woodbury_precond_apply

    _, cg, Xq = _gp_2048(cuda)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    core, data, samples, cache = cg.core, cg.data, cg.samples, cg.caches
    Xs = torch.as_tensor(Xq, device=cuda)
    B = torch.randn((1, 2048, 100), device=cuda)
    apply = woodbury_precond_apply(cache.L, core.noise_base(samples), cache.Q)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        X, res = pcg_solve(lambda V: cache.Kt @ V, B, precond_apply=apply, n_iters=32)
        with torch.no_grad():
            mu, var = core.predict_scaled(samples, cache, data, Xs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(X).all() and torch.isfinite(mu).all() and (var > 0).all()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            pcg_solve(lambda V: cache.Kt @ V, B, n_iters=1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
def test_hebo_large_n_suggest_on_card(cuda):
    """HEBO at full defaults with 3000 Sobol observations: the generic route
    (fit on a 2048-point subsample, CG posterior at bucket 3072, no fused
    graph) gives a finite batch of 8 inside the box, new against the
    history."""
    from hebo_tpu_torch import HEBO, DesignSpace

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = HEBO(space, device="cuda")
    warm = opt.quasi_sample(3000)
    opt.observe(warm, _ackley(warm))
    rec = opt.suggest(8)
    X = space.transform(rec)
    assert len(rec) == 8 and np.isfinite(X).all()
    assert (X >= space.opt_lb).all() and (X <= space.opt_ub).all()
    hist = {tuple(np.round(r, 6)) for r in space.transform(opt.X)}
    assert not ({tuple(np.round(r, 6)) for r in X} & hist)
    assert not opt._graphs and opt.model.caches.Kt is not None
    assert opt.model.fit_data.X.shape[0] == 2048 and opt.model.data.X.shape[0] == 3072
    assert bool(opt.model.caches.ok.all()) and float(opt.model.caches.res.max()) < 0.2


def _gp_cuda(n=100, seed=0, **conf):
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.models.gp.gp import GP

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    X = space.sobol_sample_opt(n, seed=seed)
    y = _ackley(space.inverse_transform(X))
    return space, GP(space, device="cuda", **conf), X, y


@pytest.mark.gpu
def test_sampler_nll_runs_k1_on_card(cuda):
    """HMC on the GP's batched loss at bucket 128, 4 chains: every
    log-density evaluation is one K1 ladder of 2 rungs at (4, 128) and one
    VJP launch (1 + 5 transitions × 2 leapfrog steps = 11 evaluations), and
    no library factorization or triangular solve runs."""
    from hebo_tpu_torch.models.gp.inference import hmc_sample
    from hebo_tpu_torch.models.gp.gp import make_data

    space, gp, X, y = _gp_cuda(num_epochs=10, n_restarts=2)
    data = make_data(X, y, gp.core.numeric_dims, 128, cuda)
    p0 = gp.core.init_params(data, 4, torch.Generator(device=cuda).manual_seed(0))
    n0 = (chol_kernel.chol_factor.launches, chol_kernel.chol_winv.launches,
          gram.matern32_gram_vjp.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        samples, acc = hmc_sample(lambda p: -gp.core.loss_batched(p, data), p0,
                                  torch.Generator(device=cuda).manual_seed(1), n_chains=4,
                                  n_warmup=4, n_samples=1, n_leapfrog=2)
        torch.cuda.synchronize()
    assert chol_kernel.chol_factor.launches - n0[0] == 22
    assert chol_kernel.chol_winv.launches - n0[1] == 22
    assert gram.matern32_gram_vjp.launches - n0[2] == 11
    names = [e.name.lower() for e in prof.events()]
    assert not any(w in n for n in names for w in ("potrf", "trsm", "cusolver", "trsv"))
    assert torch.isfinite(samples.log_ls).all() and acc.shape == (4,)


@pytest.mark.gpu
def test_thompson_joint_factor_runs_k1_on_card(cuda):
    """GP.sample_f at bucket 128 with 64 queries: the joint factor is K1's
    5-rung ladder at (1, 64), and the mean of 512 draws lies within
    4σ/√512 of predict (σ² with the factor's 1e-5 jitter)."""
    space, gp, X, y = _gp_cuda(num_epochs=20, n_restarts=2)
    gp.fit(X, y)
    Xq = space.sobol_sample_opt(64, seed=3)
    n0 = chol_kernel.chol_factor.launches
    draws = gp.sample_f(n_samples=512, seed=0)(Xq)
    assert chol_kernel.chol_factor.launches - n0 == 5
    mu, var = gp.predict(Xq)
    sd = np.sqrt(var + 1e-5 * float(gp.data.y_std) ** 2)
    assert draws.shape == (512, 64, 1) and np.isfinite(draws).all()
    assert (np.abs(draws.mean(0) - mu) <= 4 * sd / np.sqrt(512)).all()


@pytest.mark.gpu
def test_hebo_graph_with_warp_and_heteroscedastic_equals_eager(cuda):
    """HEBO with ``{"input_warp": True, "heteroscedastic": True}`` at bucket
    128 stays on the fused graph (noise_w among the draws' leaves) and gives
    the eager CUDA path's suggestion at the same seed."""
    import pandas as pd

    from hebo_tpu_torch import HEBO, DesignSpace

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = HEBO(space, device="cuda", model_config={"input_warp": True, "heteroscedastic": True})
    warm = space.inverse_transform(space.sobol_sample_opt(112, seed=1))
    opt.observe(warm, _ackley(warm))
    rec_g = opt.suggest(8)
    assert [k[0] for k in opt._graphs] == [128]
    assert opt.model.params.noise_w.shape == (1, 7)
    rec_g = opt.suggest(8)  # a replay
    alpha_g = opt.model.caches.alpha.clone()
    opt._use_graphs = False
    try:
        rec_e = opt.suggest(8)
    finally:
        opt._use_graphs = True
    pd.testing.assert_frame_equal(rec_g, rec_e)
    assert torch.equal(opt.model.caches.alpha, alpha_g)


@pytest.mark.gpu
def test_hebo_slice_graph_replays_its_coordinate_step(cuda):
    """``optimizer="slice"`` on the fused graph: three graphs in one pool
    (before the slice sampler, its coordinate step replayed once per step,
    after it); a replay gives the eager CUDA path's suggestion, caches and
    kernel launches at the same seed, and makes no host sync."""
    import pandas as pd

    from hebo_tpu_torch import HEBO, DesignSpace
    from hebo_tpu_torch.optimizers.hebo import COUNTED

    space = DesignSpace([{"name": "x0", "type": "num", "lb": -2, "ub": 2}])
    opt = HEBO(space, device="cuda", pop=20, iters=5, model_config={"optimizer": "slice"})
    warm = space.inverse_transform(space.sobol_sample_opt(12, seed=1))
    opt.observe(warm, warm[["x0"]].values ** 2)
    opt.suggest(2)  # captures bucket 16
    (key, g), = opt._graphs.items()
    # 22 sweeps over log_ls, sc, noise, mean, wa, wb
    assert key[0] == 16 and [n for _, n in g.graphs.parts] == [1, 22 * 6, 1]
    counts = {w: w.launches for w in COUNTED}
    rec_g = opt.suggest(2)  # a replay
    launches_g = {w.__name__: w.launches - counts[w] for w in COUNTED}
    alpha_g = opt.model.caches.alpha.clone()
    opt._use_graphs = False
    counts = {w: w.launches for w in COUNTED}
    try:
        rec_e = opt.suggest(2)
    finally:
        opt._use_graphs = True
    launches_e = {w.__name__: w.launches - counts[w] for w in COUNTED}
    pd.testing.assert_frame_equal(rec_g, rec_e)
    assert torch.equal(opt.model.caches.alpha, alpha_g)
    assert launches_g == launches_e and launches_g["chol_factor"] > 22 * 6 * 33

    Xv = space.transform(opt.X).astype(np.float32)
    n_pad, meta, host = opt._suggest_inputs(Xv, opt.y.astype(np.float32), 2.0, None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = opt._device_suggest(n_pad, meta, host)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out).all()


@pytest.mark.gpu
def test_horseshoe_chain_runs_k1_on_card(cuda):
    """BOCS's Gibbs chain on the card with fed draws: the same coefficient
    draws as on the CPU (rtol 1e-4; K1 against the plain ladder), five K1
    pairs per sweep (the ladder's rungs, every one launched), and no
    library factorization or triangular solve."""
    from hebo_tpu_torch.models import linreg

    rng = np.random.default_rng(0)
    n, p, T = 60, 40, 6
    Phi = rng.integers(0, 2, (n, p)).astype(np.float32)
    Phi[:, 0] = 1.0
    y = (Phi[:, 1:2] - 0.5 * Phi[:, 2:3] + 0.1 * rng.standard_normal((n, 1))).astype(np.float32)
    d = linreg.draw_gibbs(T, n, p, torch.Generator().manual_seed(1), "cpu")
    want = linreg.horseshoe_gibbs(torch.as_tensor(Phi), torch.as_tensor(y), T, draws=d)
    n0 = (chol_kernel.chol_factor.launches, chol_kernel.chol_winv.launches)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = linreg.horseshoe_gibbs(torch.as_tensor(Phi, device=cuda), torch.as_tensor(y, device=cuda),
                                     T, draws=linreg.GibbsDraws(*(t.to(cuda) for t in d)))
        torch.cuda.synchronize()
    assert chol_kernel.chol_factor.launches - n0[0] == 5 * T
    assert chol_kernel.chol_winv.launches - n0[1] == 5 * T
    names = [e.name.lower() for e in prof.events()]
    assert not any(w in n for n in names for w in ("potrf", "trsm", "cusolver", "trsv"))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_interleaved_descent_runs_k2_vjp_on_card(cuda):
    """The interleaved search's gradient steps on a transformed-overlap GP
    (3 numerics, 6 binary categoricals) fitted on the card: one K2 VJP
    launch per step, the descended points within 1e-3 of the same descent
    on the CPU from the same fitted state."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.acq_optimizers.mcbo_opts import InterleavedSearchAcqOptimizer
    from hebo_tpu_torch.acquisitions.acq import EI, AcqParams
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.models.gp.gp import GPData
    from hebo_tpu_torch.models.gp.tree import tree_map

    space = DesignSpace([{"name": f"b{i}", "type": "cat", "categories": ["0", "1"]} for i in range(6)]
                        + [{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(3)])
    X = space.sobol_sample_opt(40, seed=0)
    y = ((X[:, 6:] ** 2).sum(1, keepdims=True) + X[:, :1]).astype(np.float32)
    gp = get_model("gp", space, device="cuda", cat_kernel="transformed_overlap", num_epochs=20).fit(X, y)
    cpu = get_model("gp", space, device="cpu", cat_kernel="transformed_overlap")
    to_cpu = lambda t: tree_map(lambda v: v.cpu(), t)
    cpu.samples, cpu.caches = to_cpu(gp.samples), to_cpu(gp.caches)
    cpu.data = GPData(*(v.cpu() for v in gp.data))
    opt = InterleavedSearchAcqOptimizer(space, n_grad_steps=8)
    X0 = space.sobol_sample_opt(8, seed=5)
    lb, ub = space.opt_lb, space.opt_ub
    pr = AcqParams(tau=float(y.min()), kappa=2.0, seed=0)
    n0 = gram.matern32_gram_vjp.launches
    got = opt.descend(gp, EI(), pr, X0, lb, ub)
    assert gram.matern32_gram_vjp.launches - n0 == 8
    want = opt.descend(cpu, EI(), pr, X0, lb, ub)
    assert np.abs(got - X0).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


@pytest.mark.gpu
def test_noisy_opt_graph_equals_eager_on_card(cuda):
    """NoisyOpt at full defaults, bucket 128: its ε is drawn with the
    suggest's other draws before replay, so the captured graph's suggestion
    equals the eager CUDA path's at the same seed."""
    import pandas as pd

    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.optimizers import NoisyOpt

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -32.768, "ub": 32.768}
                         for i in range(6)])
    opt = NoisyOpt(space, device="cuda")
    warm = space.inverse_transform(space.sobol_sample_opt(112, seed=1))
    opt.observe(warm, _ackley(warm))
    rec_g = opt.suggest(8)  # captures bucket 128
    assert list(opt._graphs) and opt._acq.n_normals == 3
    assert opt.suggest(8).equals(rec_g)
    opt._use_graphs = False
    pd.testing.assert_frame_equal(opt.suggest(8), rec_g)


@pytest.mark.gpu
def test_lbfgs_runs_k2_vjp_on_card(cuda):
    """Multi-start L-BFGS on a GP's LCB fitted on the card: one K2 VJP
    launch per gradient (the first and one per iteration), and every
    start's point and value within 1e-4 of the same 3 iterations on the
    CPU from the same fitted state (the plain Gram and its autograd)."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.acq_optimizers.solvers import lbfgs_batch
    from hebo_tpu_torch.acquisitions.acq import LCB, AcqParams
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.models.gp.gp import GPData
    from hebo_tpu_torch.models.gp.tree import tree_map

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": 0.0, "ub": 1.0} for i in range(6)])
    X = space.sobol_sample_opt(60, seed=0).astype(np.float32)
    y = (((X - 0.4) ** 2).sum(1, keepdims=True) + 0.3 * np.sin(5 * X[:, :1])).astype(np.float32)
    gp = get_model("gp", space, device="cuda", num_epochs=30).fit(X, y)
    cpu = get_model("gp", space, device="cpu")
    to_cpu = lambda t: tree_map(lambda v: v.cpu(), t)
    cpu.samples, cpu.caches = to_cpu(gp.samples), to_cpu(gp.caches)
    cpu.data = GPData(*(v.cpu() for v in gp.data))
    X0 = space.sobol_sample_opt(8, seed=5).astype(np.float32)
    acq, pr = LCB(), AcqParams(kappa=2.0)
    runs = {}
    for m in (gp, cpu):
        dev = m.device
        f = lambda args, Xc, m=m: acq.eval_pure(m, args[0], args[1], Xc)
        n0 = gram.matern32_gram_vjp.launches
        runs[dev.type] = lbfgs_batch(f, (m.state, pr), torch.as_tensor(X0, device=dev),
                                     torch.zeros(6, device=dev), torch.ones(6, device=dev), 3, 8)
        if dev.type == "cuda":
            assert gram.matern32_gram_vjp.launches - n0 == 4
    (Xg, fg), (Xc, fc) = runs["cuda"], runs["cpu"]
    assert np.abs(Xg.cpu().numpy() - X0).max() > 1e-3
    torch.testing.assert_close(Xg.cpu(), Xc, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fg.cpu(), fc, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_ladder_factor_inv_backward_on_card(cuda):
    """The differentiable ladder factor (SVGP's ELBO): K1 forward, the
    W-product backward, against the CPU's plain factor and the same
    backward, 1e-4 of the largest entry."""
    from hebo_tpu_torch.ops.chol import ladder_factor_inv

    rng = np.random.default_rng(3)
    K = torch.as_tensor(_spd(rng, 2, 96))
    gL, gW = (torch.as_tensor(rng.normal(size=(2, 96, 96)).astype(np.float32)) for _ in range(2))
    grads = {}
    for dev in ("cpu", cuda):
        Kd = K.to(dev).requires_grad_(True)
        n0 = chol_kernel.chol_factor.launches
        L, W, ok = ladder_factor_inv(Kd)
        assert bool(ok.all())
        if dev == cuda:
            assert chol_kernel.chol_factor.launches > n0
        grads[str(dev)], = torch.autograd.grad((L * gL.to(dev)).sum() + (W * gW.to(dev)).sum(), Kd)
    want = grads["cpu"]
    torch.testing.assert_close(grads[str(cuda)].cpu(), want, rtol=0, atol=1e-4 * want.abs().max().item())


@pytest.mark.gpu
def test_rducb_on_card_equals_cpu(cuda):
    """RDUCB's pieces on the card against the CPU: the Gibbs structure
    learner with the same fed draws (the same assignment), and the
    message-passing optimizer on an RDGP fitted on the card and copied to
    the CPU (the same points)."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.acq_optimizers.message_passing import MessagePassingOptimizer
    from hebo_tpu_torch.acquisitions.acq import LCB, AcqParams
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.models.gp.gp import GPData, make_data
    from hebo_tpu_torch.models.gp.structure import learn_assignment
    from hebo_tpu_torch.models.gp.tree import tree_map

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(8)])
    X = space.sobol_sample_opt(100, seed=0).astype(np.float32)
    y = (np.sin(3 * X[:, :1] * X[:, 1:2]) + (X[:, 2:3] - X[:, 3:4]) ** 2 + X[:, 4:5]).astype(np.float32)
    rng = np.random.default_rng(0)
    draws = (torch.as_tensor(rng.permutation(8)), torch.as_tensor(rng.gumbel(size=(16, 6)).astype(np.float32)))
    z = {}
    for dev in ("cpu", cuda):
        d = make_data(X, y, tuple(range(8)), 128, dev)
        z[str(dev)], _ = learn_assignment(d.X, d.y, d.mask, d.x_lb, d.x_span, tuple(range(8)), (),
                                          M=6, max_group_size=3, n_sweeps=2,
                                          draws=tuple(t.to(dev) for t in draws))
    assert torch.equal(z[str(cuda)].cpu(), z["cpu"])
    gp = get_model("gp_rd", space, device="cuda", num_epochs=30).fit(X, y)
    cpu = get_model("gp_rd", space, device="cpu")
    cpu.cliques = gp.cliques
    cpu._rebuild_core()
    to_cpu = lambda t: tree_map(lambda v: v.cpu(), t)
    cpu.samples, cpu.caches = to_cpu(gp.samples), to_cpu(gp.caches)
    cpu.data = GPData(*(v.cpu() for v in gp.data))
    mp = MessagePassingOptimizer(space)
    got = mp.optimize(gp, LCB(), AcqParams(kappa=2.0), n_suggestions=2, seed=4)
    want = mp.optimize(cpu, LCB(), AcqParams(kappa=2.0), n_suggestions=2, seed=4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,epochs", [(0, 20), (1, 20), (2, 20), (0, 30), (0, 50)])
def test_svgp_elbo_gradient_on_card_equals_cpu(cuda, seed, epochs):
    """SVGP's ELBO on the card (K2 and its VJP for the Grams, K1's ladder
    and its W-product backward for the factors) against the float64 CPU
    gradient from the same fitted parameters, at five fitted points (seeds
    0-2 after 20 Adam epochs, seed 0 after 30 and 50).  The loss within 1e-4
    relative; the gradient of each leaf within c·ε₃₂·M elementwise, where M
    is the sum of the magnitudes of the terms that make it up
    (``bench/svgp_grad_probe.gradient_terms``: Σ |∂L/∂K| ⊙ |∂K/∂θ| over Kmm
    and Kmn for log ℓ, log σ² and Z) and c = n − 1 for the n = M·N + M²
    Gram entries that every leaf's gradient depends on through the
    factorization (float32's recursive-summation bound, (n − 1)·ε relative
    to the sum of the magnitudes).  The outputscale's gradient cancels to
    ~1e-6 of its terms at 50 epochs, where the card's float32 gradient is
    11 % of its largest value off the float64 one; the largest measured
    |error| / (ε₃₂·M) on an H100 is Z's, 2298 against c = 13311 (float32 on
    the CPU: 2989)."""
    from hebo_tpu_torch.bench.svgp_grad_probe import EPS32, LEAVES, fit, gradient, gradient_terms

    m = fit(seed, epochs, device="cuda")
    n0 = gram.matern32_gram_vjp.launches
    lg, gg = gradient(m, cuda)
    assert gram.matern32_gram_vjp.launches - n0 == 2
    g64, M = gradient_terms(m)
    l64, _ = gradient(m, "cpu", torch.float64)
    n = m.params.Z.shape[1] * (m.data.X.shape[0] + m.params.Z.shape[1])
    torch.testing.assert_close(lg.cpu().double(), l64, rtol=1e-4, atol=0)
    for k in LEAVES:
        err = (gg[k].cpu().double() - g64[k]).abs()
        assert bool((err <= (n - 1) * EPS32 * M[k]).all()), (k, float((err / (EPS32 * M[k])).max()), n - 1)


@pytest.mark.gpu
def test_deep_ensemble_fit_on_card_equals_cpu(cuda):
    """The ensemble's batched fit on the card (one baddbmm per layer over the
    members, Adam) against the CPU from the same initial weights and
    bootstrap: the params and the predictions within 1e-4 of their largest
    |value| after 10 epochs."""
    from hebo_tpu_torch import DesignSpace
    from hebo_tpu_torch.models import get_model
    from hebo_tpu_torch.models.gp.tree import tree_leaves, tree_unflatten
    from hebo_tpu_torch.models.nn.deep_ensemble import init_mlp

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -1.0, "ub": 1.0} for i in range(3)]
                        + [{"name": "c", "type": "cat", "categories": ["a", "b", "c"]}])
    X = space.sobol_sample_opt(32, seed=0).astype(np.float32)
    y = (np.sin(2 * X[:, :1]) + X[:, 1:2] ** 2).astype(np.float32)
    init = init_mlp(5, [6, 64, 64, 2], torch.Generator().manual_seed(0), "cpu")
    out = {}
    for dev in (cuda, "cpu"):
        m = get_model("deep_ensemble", space, device=dev, num_epochs=10)
        m.fit(X, y, init=tree_unflatten(init, [t.to(dev) for t in tree_leaves(init)]))
        out[str(dev)] = ([t.cpu() for t in tree_leaves(m.params)], m.predict(X))
    (pg, (mg, vg)), (pc, (mc, vc)) = out[str(cuda)], out["cpu"]
    for g, c in zip(pg, pc):
        torch.testing.assert_close(g, c, rtol=0, atol=1e-4 * c.abs().max().item())
    np.testing.assert_allclose(mg, mc, rtol=0, atol=1e-4 * np.abs(mc).max())
    np.testing.assert_allclose(vg, vc, rtol=0, atol=1e-4 * np.abs(vc).max())


@pytest.mark.gpu
def test_nap_task_sampler_runs_k1_on_card(cuda):
    """NAP's ``sample_gp_tasks`` at its meta-training shape (16 tasks of 32
    points) factors through K1 (one K1a and one K1b launch, no library
    factor) and gives the CPU's X exactly; its y lies as close to a float64
    factor of the same Grams as 10× the CPU's float32 y does (the RBF Grams
    with ℓ up to e^0.5 on [−1, 1]³ have condition numbers near 1e5, so the
    two float32 factors differ in their last pivots)."""
    from hebo_tpu_torch.meta.nap import draw_tasks, sample_gp_tasks

    for cat in ((), (1,)):
        ncat = (3,) if cat else ()
        d = draw_tasks(16, 32, 3, ncat, torch.Generator().manual_seed(1), "cpu")
        n0, w0 = chol_kernel.chol_factor.launches, chol_kernel.chol_winv.launches
        Xg, yg = sample_gp_tasks(16, 32, 3, cat, ncat,
                                 draws=type(d)(*(None if t is None else t.to(cuda) for t in d)))
        assert (chol_kernel.chol_factor.launches - n0, chol_kernel.chol_winv.launches - w0) == (1, 1)
        Xc, yc = sample_gp_tasks(16, 32, 3, cat, ncat, draws=d)
        d64 = type(d)(*(t if t is None or not t.is_floating_point() else t.double() for t in d))
        _, y64 = sample_gp_tasks(16, 32, 3, cat, ncat, draws=d64)
        torch.testing.assert_close(Xg.cpu(), Xc, rtol=0, atol=0)
        err_card = (yg.cpu().double() - y64).abs().max().item()
        err_cpu = (yc.double() - y64).abs().max().item()
        assert err_card <= 10 * err_cpu + 1e-6, (err_card, err_cpu)


@pytest.mark.gpu
def test_gbdt_fit_on_card_equals_cpu(cuda):
    """The forest's rounds × levels loop on the card against the CPU with the
    same row bags and leaf noise: the same splits, or at the first split
    that differs two scores tied within float32 rounding, and then the
    forest grown from the CPU's splits; leaf values within 1e-5 of their
    largest |value|."""
    from hebo_tpu_torch.models.boosting import fit_forest

    rng = np.random.default_rng(0)
    N, F, R, T, B = 1024, 8, 40, 4, 32
    codes = torch.as_tensor(rng.integers(0, B, (N, F)))
    y = torch.as_tensor(np.sin(codes[:, 0].numpy() / 5.0) + 0.1 * rng.standard_normal(N),
                        dtype=torch.float32)
    mask = torch.as_tensor(np.arange(N) < 1000)
    bags = torch.as_tensor(rng.random((R, N)) < 0.8)
    eps = torch.as_tensor(rng.standard_normal((R, 2 ** T, 2)), dtype=torch.float32)
    args = dict(n_rounds=R, depth=T, n_bins=B)
    cpu = fit_forest(codes, y, mask, bags=bags, eps=eps, **args)
    trace = []
    on = lambda t: t.to(cuda)  # noqa: E731
    free = fit_forest(on(codes), on(y), on(mask), bags=on(bags), eps=on(eps), **args)
    forced = fit_forest(on(codes), on(y), on(mask), bags=on(bags), eps=on(eps),
                        splits=(on(cpu.feats), on(cpu.bins)), trace=trace, **args)
    same = ((free.feats.cpu() == cpu.feats) & (free.bins.cpu() == cpu.bins)).numpy()
    if not same.all():
        r, t = np.argwhere(~same)[0]
        score = trace[r * T + t].cpu()
        mine = score[free.feats[r, t].item(), free.bins[r, t].item()]
        theirs = score[cpu.feats[r, t], cpu.bins[r, t]]
        assert abs(float(mine - theirs)) <= 1e-5 * abs(float(mine))
    else:
        torch.testing.assert_close(free.leaf_w.cpu(), cpu.leaf_w, rtol=0,
                                   atol=1e-5 * cpu.leaf_w.abs().max().item())
    torch.testing.assert_close(forced.leaf_w.cpu(), cpu.leaf_w, rtol=0,
                               atol=1e-5 * cpu.leaf_w.abs().max().item())


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL group on the card and its 1-D mesh (the mesh paths'
    world on a one-card machine)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 -m pytest --noconftest -m gpu tests/test_torch_cuda.py)")
    import torch.distributed as dist

    from hebo_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def _matern_system(dev, N, seed=0):
    """A GP train system: the Matérn-3/2 Gram of N points in [−1, 1]^6 at
    lengthscale 0.5 plus noise 1e-3 on the diagonal."""
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(-1, 1, (1, N, 6)).astype(np.float32), device=dev) / 0.5
    K = matern32_gram(X, X, torch.ones(1, device=dev))[0]
    return (K + 1e-3 * torch.eye(N, device=dev)).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("N,block", [(1024, 128), (256, 32)])
def test_block_factor_on_card_equals_dense_ladder(nccl_mesh, N, block):
    """The row-slab factor (K1a per diagonal block; a block narrower than a
    tile assembles the tile inverses) and its W = L⁻¹ (K1b at the full
    size) against K1's dense ladder at the same jitter: relative Frobenius
    error ≤ 1e-3; N / block K1a launches, no library factor."""
    from hebo_tpu_torch.ops.block_chol import block_ladder_factor
    from hebo_tpu_torch.ops.chol import LADDER, batched_ladder_factor

    K = _matern_system(torch.device("cuda"), N)
    n0 = chol_kernel.chol_factor.launches
    L, W, ok = block_ladder_factor(K, nccl_mesh, block=block)
    assert chol_kernel.chol_factor.launches - n0 == N // block and bool(ok)
    Ld, Wd, okd = batched_ladder_factor(K[None], LADDER)
    assert bool(okd[0])
    for got, want in ((L, Ld[0]), (W, Wd[0])):
        assert (torch.linalg.norm(got - want) / torch.linalg.norm(want)).item() <= 1e-3


@pytest.mark.gpu
def test_sharded_smc_on_card_equals_unsharded(nccl_mesh):
    """SMC over the GP's NLL (K1 at (32, 128)) on the one-rank mesh against
    the unsharded sampler with the same generator: particles and log
    evidence within 1e-5."""
    from hebo_tpu_torch.models.gp.gp import GPCore, make_data
    from hebo_tpu_torch.models.gp.inference import smc_sample, smc_sample_sharded

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    data = make_data(X, np.sin(3 * X).sum(1, keepdims=True), (0, 1, 2), 128, dev)
    core = GPCore(numeric_dims=(0, 1, 2), cat_dims=(), num_categories=())
    parts0 = core.init_params(data, 32, torch.Generator(device=dev).manual_seed(0))
    lik = lambda p: -core.nll_batched(p, data)  # noqa: E731
    kw = dict(n_stages=6)
    a, za = smc_sample_sharded(core.log_prior, lik, parts0, torch.Generator(device=dev).manual_seed(3),
                               nccl_mesh, **kw)
    b, zb = smc_sample(core.log_prior, lik, parts0, torch.Generator(device=dev).manual_seed(3), **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(za, zb, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_ppo_update_on_card_equals_cpu(nccl_mesh):
    """One ``ppo_train`` iteration (2 Adam steps) on the one-rank mesh on the
    card, its tasks factored by K1 at (4, 8), against the CPU port from the
    same weights and draws: params within 1e-4 of each tensor's largest
    |value|, but the zero-gradient biases (key projections, the logit
    head), within Adam's reach of their start."""
    from hebo_tpu_torch.meta.nap import TaskDraws
    from hebo_tpu_torch.meta.ppo import NAPPolicy, RolloutDraws, ppo_train

    rng = np.random.default_rng(2)
    Bn, C, T, dx = 4, 8, 3, 2
    t = lambda *s: torch.as_tensor(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    draws = RolloutDraws(TaskDraws(X=torch.as_tensor(rng.uniform(-1, 1, (Bn, C, dx)).astype(np.float32)),
                                   codes=None, log_ls=torch.full((Bn, 1, 1, 1), -0.5),
                                   z=t(Bn, C), eps=t(Bn, C, 1)),
                         torch.as_tensor(rng.gumbel(size=(T, Bn, C)).astype(np.float32)))
    cpu = NAPPolicy(dx, 16, 2, 1, generator=torch.Generator().manual_seed(0))
    card = NAPPolicy(dx, 16, 2, 1, device="cuda")
    card.load_state_dict(cpu.state_dict())
    kw = dict(batch=Bn, n_cand=C, horizon=T, n_iters=1, draws=lambda it: draws)
    n0 = chol_kernel.chol_factor.launches
    pc, rc = ppo_train(card, mesh=nccl_mesh, axis="pop", **kw)
    assert chol_kernel.chol_factor.launches > n0
    pp, rp = ppo_train(cpu, **kw)
    start = dict(cpu.named_parameters())
    for k, v in pp.items():
        if ".attn.key.bias" in k or "logit_head.bias" in k:
            assert (pc[k].cpu() - start[k]).abs().max().item() <= 2 * 3e-4 * (1 + 1e-3)
        else:
            torch.testing.assert_close(pc[k].cpu(), v, rtol=0, atol=1e-4 * v.abs().max().item())
    np.testing.assert_allclose(rc, rp, rtol=1e-5, atol=1e-5)


def _vae_case(kind, device, rng, n=24):
    """A VAE family at the latent loops' widths (chip_smoke phase n) and its
    training data: pest control's categorical VAE (25 columns × 5 codes,
    latent 4), the topology VAE at 40 × 40 (latent 8) and chem's sequence
    VAE (16 tokens, length 24, latent 8)."""
    from hebo_tpu_torch.latent import decoders, vae

    if kind == "vae":
        model, lat = vae.VAE(4, 25, 64, (5,) * 25, device=device), 4
        X = rng.integers(0, 5, (n, 25)).astype(np.float32)
        train = vae.train_vae
    elif kind == "topology":
        model, lat = decoders.TopologyVAE(8, (40, 40), device=device), 8
        X = (rng.random((n, 40, 40, 1)) < 0.3).astype(np.float32)
        train = decoders.train_topology_vae
    else:
        model, lat = decoders.SeqVAE(16, 24, 8, device=device), 8
        X = rng.integers(0, 16, (n, 24)).astype(np.int32)
        train = decoders.train_seq_vae
    y = X.reshape(n, -1).mean(1, keepdims=True).astype(np.float32)
    w = vae.rank_weights(y[:, 0]).astype(np.float32)
    return model, train, X, y, w, rng.standard_normal((3, n, lat)).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["vae", "topology", "seq"])
def test_vae_train_steps_on_card_equal_cpu(cuda, kind):
    """Three ``train_*`` Adam steps on the card from the CPU's initial
    weights with the same fed normals: the float32 losses within 1e-5
    (relative), and in float64 every parameter within 1e-4 of its tensor's
    largest |value|.  (In float32, Adam's per-element step g / (√v + ε)
    turns the rounding of a gradient that cancels to ~ε into steps of
    different sizes: the sequence VAE's encoder GRU input weights, ~5e-9.)"""
    from hebo_tpu_torch.latent.vae import init_params

    cpu, train, X, y, w, noise = _vae_case(kind, "cpu", np.random.default_rng(5))
    card = _vae_case(kind, cuda, np.random.default_rng(5))[0]
    p0 = init_params(cpu)
    _, lc = train(cpu, p0, X, y, w, n_steps=3, noise=noise)
    _, lg = train(card, {k: v.to(cuda) for k, v in p0.items()}, X, y, w, n_steps=3, noise=noise)
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    p64 = {k: v.double() for k, v in p0.items()}
    pc, _ = train(cpu, p64, X, y, w, n_steps=3, noise=noise)
    pg, _ = train(card, {k: v.to(cuda) for k, v in p64.items()}, X, y, w, n_steps=3, noise=noise)
    assert set(pg) == set(pc)
    for k, v in pc.items():
        torch.testing.assert_close(pg[k].cpu(), v, rtol=0, atol=1e-4 * v.abs().max().item())


@pytest.mark.gpu
def test_sac_update_on_card_equals_cpu(cuda):
    """One SAC update and one guided update on the card from the CPU's
    initial weights, with the same batch and normals: parameters, targets
    and log α within 1e-5 of each tensor's largest |value| (float32), Adam's
    moments 1e-4."""
    from hebo_tpu_torch.rl import SAC, GuidedSAC

    rng = np.random.default_rng(0)
    B = 128
    batch = (rng.standard_normal((B, 3)).astype(np.float32), rng.standard_normal((B, 1)).astype(np.float32),
             rng.standard_normal(B).astype(np.float32), rng.standard_normal((B, 3)).astype(np.float32),
             (rng.random(B) < 0.1).astype(np.float32), np.zeros(B, np.float32))
    eps = tuple(rng.standard_normal((B, 1)).astype(np.float32) for _ in range(2))
    guide, region = (lambda o: -0.5 * o[..., 2:3]), (lambda o: (o[..., 0] < 0).to(o.dtype))
    for make in (lambda d: SAC(3, 1, 2.0, device=d), lambda d: GuidedSAC(3, 1, guide, region, act_limit=2.0, device=d)):
        cpu, card = make("cpu"), make(cuda)
        s0 = cpu.init(torch.Generator().manual_seed(0))
        want = cpu.update(s0, batch, eps=eps)
        mv = lambda d: {k: v.to(cuda) for k, v in d.items()}
        got = card.update(card.state_from(mv(s0.actor), mv(s0.q1), mv(s0.q2)), batch, eps=eps)
        for f in ("actor", "q1", "q2", "q1_targ", "q2_targ"):
            for k, v in getattr(want, f).items():
                torch.testing.assert_close(getattr(got, f)[k].cpu(), v, rtol=0, atol=1e-5 * v.abs().max().item())
        torch.testing.assert_close(got.log_alpha.cpu(), want.log_alpha, rtol=1e-5, atol=1e-9)
        for f in ("opt_actor", "opt_q"):
            for k, v in getattr(want, f).mu.items():
                torch.testing.assert_close(getattr(got, f).mu[k].cpu(), v, rtol=0, atol=1e-4 * v.abs().max().item())


@pytest.mark.gpu
def test_tinylm_forward_on_card_equals_cpu(cuda):
    """TinyLM at its defaults (vocab 32) with weights perturbed off flax's
    init (so the MaPO statistic is not rounding noise): logits and the
    three mask outputs within 1e-5 of the CPU's largest |value|."""
    from torch.func import functional_call

    from hebo_tpu_torch.po import TinyLM

    cpu = TinyLM(32, generator=torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    params = {k: v.detach() + 0.1 * torch.randn(v.shape, generator=g) for k, v in cpu.named_parameters()}
    card = TinyLM(32, device=cuda)
    tok = torch.randint(0, 32, (8, 64), generator=g)
    with torch.no_grad():
        lc, mc = functional_call(cpu, params, (tok,))
        lg, mg = functional_call(card, {k: v.to(cuda) for k, v in params.items()}, (tok.to(cuda),))
    torch.testing.assert_close(lg.cpu(), lc, rtol=0, atol=1e-5 * lc.abs().max().item())
    for k, v in mc.items():
        torch.testing.assert_close(mg[k].cpu(), v, rtol=0, atol=1e-5 * v.abs().max().item())


@pytest.mark.gpu
def test_resumed_hebo_on_card_suggests_as_uninterrupted(cuda, tmp_path):
    """A HEBO restored from a checkpoint captures a fresh graph where the
    uninterrupted one replays its own: the same suggestion, bit for bit."""
    from hebo_tpu_torch import DesignSpace, HEBO
    from hebo_tpu_torch.utils.checkpoint import load_optimizer, save_optimizer

    space = DesignSpace([{"name": f"x{i}", "type": "num", "lb": -2, "ub": 2} for i in range(4)])
    f = lambda df: (df.values.astype(float) ** 2).sum(1, keepdims=True)
    opt = HEBO(space, device=cuda, pop=32, iters=16, model_config={"num_epochs": 16})
    for _ in range(6):
        rec = opt.suggest(4)
        opt.observe(rec, f(rec))
    save_optimizer(opt, str(tmp_path / "c.ckpt"))
    resumed = load_optimizer(HEBO(space, device=cuda, pop=32, iters=16, model_config={"num_epochs": 16}),
                             str(tmp_path / "c.ckpt"))
    assert opt.suggest(4).equals(resumed.suggest(4))


@pytest.mark.gpu
def test_masked_attention_on_card_equals_cpu(cuda):
    """EM-LLM's masked attention at Llama-3-8B's widths (8 heads of 128):
    within 1e-5 of the CPU's largest |output|; a fully masked key set gives
    the mean of V (masked logits are −1e9)."""
    from hebo_tpu_torch.emllm import masked_attention

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((n, 8, 128), generator=g) for n in (64, 700, 700))
    for mask in (torch.rand(700, generator=g) < 0.7, torch.zeros(700, dtype=torch.bool)):
        want = masked_attention(q, k, v, mask)
        got = masked_attention(q.to(cuda), k.to(cuda), v.to(cuda), mask.to(cuda)).cpu()
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * want.abs().max().item())
    torch.testing.assert_close(got, v.mean(0).expand_as(got), rtol=0, atol=1e-5 * v.abs().max().item())


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["reps", "full"])
def test_episodic_retrieve_on_card_equals_cpu(cuda, mode):
    """A 64-event memory at full width on the card and on the CPU: the same
    ids for 8 queries, and ``gather_kv`` the same bits."""
    from hebo_tpu_torch.emllm import EpisodicKVMemory

    rng = np.random.default_rng(0)
    mems = [EpisodicKVMemory(event_len=128, device=d) for d in (cuda, "cpu")]
    for _ in range(16):
        K, V = (rng.standard_normal((512, 8, 128)).astype(np.float32) for _ in range(2))
        edges = [0, *np.sort(rng.choice(np.arange(16, 496), 3, replace=False)).tolist(), 512]
        for m in mems:
            m.add_events(K, V, list(zip(edges[:-1], edges[1:])))
    for _ in range(8):
        q = rng.standard_normal((16, 8, 128)).astype(np.float32)
        ids = [m.retrieve(q, 4, 1, mode=mode) for m in mems]
        assert ids[0] == ids[1]
        for a, b in zip(*(m.gather_kv(ids[0]) for m in mems)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_segment_events_on_card_equals_cpu(cuda):
    """Surprise segmentation of 4 seeded (512, 1024) key chunks: the same
    spans on the card as on the CPU, but where the CPU's top-two scores of
    a boundary lie within 1e-6 relative (a float32 tie)."""
    from hebo_tpu_torch.emllm import segment_events

    rng = np.random.default_rng(1)
    for _ in range(4):
        keys = rng.standard_normal((512, 1024)).astype(np.float32)
        s = 0.1 * rng.random(512)
        s[[128, 256, 384]] = 10.0
        s[rng.random(512) > 0.98] += 5.0
        tr = [[], []]
        sp = [segment_events(torch.as_tensor(keys, device=d), s, min_event=32, trace=t)
              for d, t in ((cuda, tr[0]), ("cpu", tr[1]))]
        if sp[0] != sp[1]:
            # the first boundary picked differently must be a tie on the CPU
            first = next(i for i, (a, b) in enumerate(zip(*tr)) if np.argmax(a[2]) != np.argmax(b[2]))
            top = np.sort(tr[1][first][2])[-2:]
            assert top[1] - top[0] <= 1e-6 * abs(top[1]), (sp, tr[1][first])
