"""hebo_tpu_torch's SSK Gram (ops/ssk.py: the plain version of kernel K3 and
``ssk_scan_plain``, the mirror of the kernel's recursion) and categorical
kernels against hebo_tpu on CPU.

The JAX side runs its Pallas SSK kernel in interpret mode, as
tests/test_pallas_ssk.py does.  Tolerances (float32 on both sides, sums in
another order):
* normalised K: 1e-5 absolute (K ∈ [0, 1]);
* raw totals: 1e-5 relative; their tangents: 1e-4 relative;
* gradients in the match / gap decays: 1e-4 relative (+1e-6 absolute);
* overlap / transformed overlap: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hebo_tpu.models.gp import kernels as jk
from hebo_tpu.ops.pallas_ssk import _raw_call
from hebo_tpu.ops.pallas_ssk import ssk_gram as jssk_gram
from hebo_tpu_torch.models.gp import kernels as tk
from hebo_tpu_torch.ops import ssk

DECAYS = [(0.6, 0.7), (0.4, 0.85)]  # a batch of two (match, gap) parameter sets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The many small ops here run no faster on more threads, and the
    test run's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(n, L, V, seed):
    return np.random.default_rng(seed).integers(0, V, (n, L)).astype(np.int32)


def _decays():
    md = torch.tensor([d[0] for d in DECAYS], requires_grad=True)
    gd = torch.tensor([d[1] for d in DECAYS], requires_grad=True)
    return md, gd


# (N, M, L, max_subseq): N, M not multiples of 8, L ∈ {6, 11}, M = 1
CASES = [(13, 5, 11, 3), (9, 7, 6, 2), (10, 1, 11, 3), (6, 11, 6, 3)]


@pytest.mark.parametrize("N,M,L,P", CASES)
def test_plain_gram_and_grads_match_pallas(N, M, L, P):
    s1, s2 = _codes(N, L, 4, N), _codes(M, L, 4, M + 100)
    w = np.random.default_rng(1).standard_normal((len(DECAYS), N, M)).astype(np.float32)
    md, gd = _decays()
    K = ssk.ssk_gram_plain(torch.as_tensor(s1), torch.as_tensor(s2), md, gd, P)
    assert K.shape == (len(DECAYS), N, M)
    gmd, ggd = torch.autograd.grad((K * torch.as_tensor(w)).sum(), (md, gd))
    for b, (m, g) in enumerate(DECAYS):
        def loss(m_, g_):
            return jnp.sum(jnp.asarray(w[b]) * jssk_gram(jnp.asarray(s1), jnp.asarray(s2), m_, g_, P,
                                                         interpret=True))

        Kj = jssk_gram(jnp.asarray(s1), jnp.asarray(s2), jnp.float32(m), jnp.float32(g), P, interpret=True)
        np.testing.assert_allclose(K[b].detach().numpy(), np.asarray(Kj), rtol=0, atol=1e-5)
        gj = jax.grad(loss, argnums=(0, 1))(jnp.float32(m), jnp.float32(g))
        np.testing.assert_allclose(gmd[b].item(), float(gj[0]), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(ggd[b].item(), float(gj[1]), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("N,M,L,P", CASES[:2])
def test_raw_totals_and_tangents_match_pallas(N, M, L, P):
    """The quantities K3 computes: cross and self totals with both tangents."""
    s1, s2 = _codes(N, L, 3, 7), _codes(M, L, 3, 8)
    lam2 = torch.tensor([d[0] ** 2 for d in DECAYS])
    gap = torch.tensor([d[1] for d in DECAYS])
    cross = ssk.ssk_cross_plain(torch.as_tensor(s1), torch.as_tensor(s2), lam2, gap, P)
    self1 = ssk.ssk_self_plain(torch.as_tensor(s1), lam2, gap, P)
    for b in range(len(DECAYS)):
        cj, s1j, _ = _raw_call(jnp.asarray(s1, jnp.float32), jnp.asarray(s2, jnp.float32),
                               jnp.float32(lam2[b].item()), jnp.float32(gap[b].item()), P, True)
        for k, rtol in enumerate((1e-5, 1e-4, 1e-4)):
            np.testing.assert_allclose(cross[k][b].numpy(), np.asarray(cj[k])[:N, :M], rtol=rtol, atol=1e-6)
            np.testing.assert_allclose(self1[k][b].numpy(), np.asarray(s1j[k])[:N], rtol=rtol, atol=1e-6)


# CASES plus L = 1, P = 1, P = 5 and M = 1
SCAN_CASES = CASES + [(7, 4, 1, 3), (8, 5, 11, 1), (6, 7, 6, 5), (9, 1, 8, 5)]


@pytest.mark.parametrize("N,M,L,P", SCAN_CASES)
def test_scan_mirror_matches_pallas(N, M, L, P):
    """ssk_scan_plain (kernel K3's recursion: rows streamed, two chains, the
    λ_m² tangent from Σ p·λ^{p−1} S_p, structural zeros skipped) against the
    JAX Pallas kernel in interpret mode, cross and self totals."""
    s1, s2 = _codes(N, L, 3, N + 20), _codes(M, L, 3, M + 40)
    lam2 = torch.tensor([d[0] ** 2 for d in DECAYS])
    gap = torch.tensor([d[1] for d in DECAYS])
    cross = ssk.ssk_scan_plain(torch.as_tensor(s1), torch.as_tensor(s2), lam2, gap, P)
    self1 = ssk.ssk_scan_plain(torch.as_tensor(s1), None, lam2, gap, P)
    self2 = ssk.ssk_scan_plain(torch.as_tensor(s2), None, lam2, gap, P)
    assert cross[0].shape == (len(DECAYS), N, M) and self1[0].shape == (len(DECAYS), N)
    for b in range(len(DECAYS)):
        cj, s1j, s2j = _raw_call(jnp.asarray(s1, jnp.float32), jnp.asarray(s2, jnp.float32),
                                 jnp.float32(lam2[b].item()), jnp.float32(gap[b].item()), P, True)
        for k, rtol in enumerate((1e-5, 1e-4, 1e-4)):
            np.testing.assert_allclose(cross[k][b].numpy(), np.asarray(cj[k])[:N, :M], rtol=rtol, atol=1e-6)
            np.testing.assert_allclose(self1[k][b].numpy(), np.asarray(s1j[k])[:N], rtol=rtol, atol=1e-6)
            np.testing.assert_allclose(self2[k][b].numpy(), np.asarray(s2j[k])[:M], rtol=rtol, atol=1e-6)


def test_self_similarity_is_one_and_bounded():
    s = torch.as_tensor(_codes(9, 11, 5, 3))
    md, gd = _decays()
    K = ssk.ssk_gram_plain(s, s, md, gd, 3).detach()
    for b in range(len(DECAYS)):
        np.testing.assert_allclose(torch.diagonal(K[b]).numpy(), 1.0, atol=1e-5)
    assert K.max() <= 1.0 + 1e-5 and K.min() >= 0.0


def test_cpu_wrapper_is_the_plain_version():
    s1, s2 = torch.as_tensor(_codes(7, 6, 3, 1)), torch.as_tensor(_codes(4, 6, 3, 2))
    md, gd = _decays()
    n = (ssk.ssk_cross.launches, ssk.ssk_self.launches)
    K = ssk.ssk_gram(s1.float(), s2.float(), md, gd, 2)
    assert (ssk.ssk_cross.launches, ssk.ssk_self.launches) == n
    torch.testing.assert_close(K, ssk.ssk_gram_plain(s1, s2, md, gd, 2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        ssk.ssk_gram(s1.to("meta"), s2.to("meta"), md.detach().to("meta"), gd.detach().to("meta"))


@pytest.mark.parametrize("P", [2, 3])
def test_einsum_reference_matches(P):
    s1, s2 = _codes(10, 11, 5, 4), _codes(7, 11, 5, 5)
    Kj = jk.ssk_kernel(jnp.asarray(s1, jnp.float32), jnp.asarray(s2, jnp.float32), 0.6, 0.7, P)
    Kt = tk.ssk_kernel(torch.as_tensor(s1), torch.as_tensor(s2), 0.6, 0.7, P)
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=0, atol=1e-5)
    md, gd = _decays()
    Kb = tk.ssk_kernel(torch.as_tensor(s1), torch.as_tensor(s2), md.detach(), gd.detach(), P)
    Kp = ssk.ssk_gram_plain(torch.as_tensor(s1), torch.as_tensor(s2), md, gd, P).detach()
    np.testing.assert_allclose(Kb.numpy(), Kp.numpy(), rtol=0, atol=1e-5)


def test_overlap_kernels_match():
    x1, x2 = _codes(12, 5, 3, 6).astype(np.float32), _codes(9, 5, 3, 7).astype(np.float32)
    theta = np.random.default_rng(2).uniform(0.2, 3.0, (2, 5)).astype(np.float32)
    np.testing.assert_allclose(tk.overlap(torch.as_tensor(x1), torch.as_tensor(x2)).numpy(),
                               np.asarray(jk.overlap(jnp.asarray(x1), jnp.asarray(x2))), atol=1e-6)
    Kb = tk.transformed_overlap(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(theta))
    for b in range(2):
        Kj = jk.transformed_overlap(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(theta[b]))
        np.testing.assert_allclose(Kb[b].numpy(), np.asarray(Kj), rtol=1e-6, atol=1e-6)
        K1 = tk.transformed_overlap(torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(theta[b]))
        np.testing.assert_allclose(K1.numpy(), np.asarray(Kj), rtol=1e-6, atol=1e-6)


def test_decay_mats_match():
    from hebo_tpu.ops.pallas_ssk import _decay_mats

    D, dD = ssk.decay_mats(torch.tensor([0.3, 0.9]), 7)
    for b, g in enumerate((0.3, 0.9)):
        Dj, dDj = _decay_mats(jnp.float32(g), 7)
        np.testing.assert_allclose(D[b].numpy(), np.asarray(Dj), rtol=1e-6)
        np.testing.assert_allclose(dD[b].numpy(), np.asarray(dDj), rtol=1e-6)
