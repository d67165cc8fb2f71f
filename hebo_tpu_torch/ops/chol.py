"""Robust Cholesky with a jitter ladder, and the masked GP NLL.

Port of ``hebo_tpu/ops/chol.py``.  Failure is detected by NaNs in the
factor, as in the JAX package (chol.py:55, :194): the plain factorizations
here NaN-fill every matrix whose ``cholesky_ex`` reports ``info != 0``
(``cholesky_ex`` alone returns a finite, wrong factor), and the CUDA kernel
(``chol_kernel``) propagates NaNs itself.

``batched_ladder_factor`` decides its retries on the device, as the JAX
package does inside its program with ``lax.cond`` (chol.py:209): every rung
is launched, and kernel K1 skips the matrices an earlier rung factored
(``skip``), so no value comes back to the host and the ladder can sit in a
captured CUDA graph.  ``ladder_factor_inv`` is the same ladder as a
differentiable function of K (SVGP's ELBO), whose backward uses only
products with W = L⁻¹.
"""

from __future__ import annotations

import math

import torch

from .chol_kernel import TILE, chol_factor, chol_winv, padded_size

__all__ = [
    "safe_cholesky", "chol_solve", "chol_logdet", "make_masked_nll",
    "make_masked_nll_batched", "batched_ladder_factor", "ladder_factor_inv", "LADDER",
]

LADDER = (0.0, 1e-6, 1e-4, 1e-2, 1.0)


def _cholesky_nan(K: torch.Tensor) -> torch.Tensor:
    L, info = torch.linalg.cholesky_ex(K)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def _all_finite(L: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(L).all(-1).all(-1)


def _scale(K: torch.Tensor) -> torch.Tensor:
    """Mean diagonal, floored at 1e-12 (the rungs are relative to it)."""
    return torch.clamp(torch.diagonal(K, dim1=-2, dim2=-1).mean(-1), min=1e-12)


def safe_cholesky(K: torch.Tensor, base_jitter: float = 1e-6, rungs=None):
    """Cholesky of ``K + jitter·I`` at the first rung that succeeds.

    Every rung is factorized, as in the JAX package.  Returns ``(L, ok)``;
    ``ok`` is False only if the largest rung failed too."""
    rungs = LADDER if rungs is None else tuple(rungs)
    n = K.shape[-1]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    scale = _scale(K)[..., None, None]
    L = _cholesky_nan(K + (base_jitter + rungs[0] * scale) * eye)
    ok = _all_finite(L)
    for rung in rungs[1:]:
        L2 = _cholesky_nan(K + (base_jitter + rung * scale) * eye)
        ok2 = _all_finite(L2)
        L = torch.where(((~ok) & ok2)[..., None, None], L2, L)
        ok = ok | ok2
    return L, ok


def chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``K x = b`` given ``K = L Lᵀ``."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


class _MaskedNLL(torch.autograd.Function):
    """0.5(rᵀS⁻¹r + log|S| + n·log 2π) of one system with the analytic
    gradient ∂/∂S = ½(S⁻¹ − ααᵀ), ∂/∂r = α (chol.py:80-129)."""

    @staticmethod
    def forward(ctx, Kt, r, n_act, rungs, base_jitter):
        L, ok = safe_cholesky(Kt, base_jitter, rungs)
        alpha = chol_solve(L, r)
        val = 0.5 * ((r * alpha).sum() + chol_logdet(L) + n_act * math.log(2.0 * math.pi))
        val = torch.where(ok, val, torch.full_like(val, 1e10))
        ctx.save_for_backward(L, alpha, ok)
        return val

    @staticmethod
    def backward(ctx, g):
        L, alpha, ok = ctx.saved_tensors
        eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
        W = torch.linalg.solve_triangular(L, eye, upper=False)
        G = 0.5 * (W.T @ W - alpha * alpha.T)
        G = torch.where(ok, G, torch.zeros_like(G)) * g
        dr = torch.where(ok, alpha, torch.zeros_like(alpha)) * g
        return G, dr, None, None, None


def make_masked_nll(rungs: tuple, base_jitter: float = 1e-6):
    """Per-system masked NLL ``f(Kt (N,N), r (N,1), n_act)`` with the
    analytic backward."""
    return lambda Kt, r, n_act: _MaskedNLL.apply(Kt, r, n_act, tuple(rungs), base_jitter)


def batched_ladder_factor(Kt: torch.Tensor, rungs: tuple, base_jitter: float = 1e-6):
    """Scale-aware jitter-ladder factorization of a (B, N, N) batch.

    Returns ``(L, W, ok)`` with ``W = L⁻¹`` of the first succeeding rung per
    matrix; a matrix that fails every rung has non-finite L and W.  Every
    rung goes through ``chol_factor`` / ``chol_winv`` (kernel K1 on CUDA)
    into one padded (L, W) pair, with the rung's jitter on the diagonal and
    the matrices that an earlier rung factored skipped: no host sync."""
    B, n, _ = Kt.shape
    Kt = Kt.contiguous()
    scale = _scale(Kt)
    Np = padded_size(n)
    L = Kt.new_empty((B, Np, Np))
    Wd = Kt.new_empty((B, Np // TILE, TILE, TILE))
    W = Kt.new_empty((B, Np, Np))
    skip = None
    for rung in rungs:
        jitter = base_jitter + rung * scale
        chol_factor(Kt, jitter, skip, out=(L, Wd))
        chol_winv(L, Wd, skip, out=W)
        ok = _all_finite(L)
        skip = ok.to(torch.int32)
    return L[:, :n, :n], W[:, :n, :n], ok


class _LadderFactorInv(torch.autograd.Function):
    """(L, W, ok) of ``batched_ladder_factor``, differentiable in K.

    The backward (Murray 2016, "Differentiation of the Cholesky
    decomposition") with W = L⁻¹ in place of triangular solves: W's
    cotangent W̄ adds −Wᵀ W̄ Wᵀ to L̄ (dW = −W dL W), then
    K̄ = Wᵀ Φ(Lᵀ tril(L̄)) W, symmetrised, where Φ keeps the lower triangle
    and halves the diagonal.  The ladder's jitter is held constant: at the
    first rung, where a well-conditioned matrix is factored, this is the
    exact gradient; the JAX package also differentiates a later rung's
    jitter through the mean diagonal it scales."""

    @staticmethod
    def forward(ctx, K, rungs, base_jitter):
        L, W, ok = batched_ladder_factor(K, rungs, base_jitter)
        ctx.save_for_backward(L, W)
        ctx.mark_non_differentiable(ok)
        return L, W, ok

    @staticmethod
    def backward(ctx, gL, gW, _gok):
        L, W = ctx.saved_tensors
        Wt = W.transpose(-1, -2)
        Lbar = torch.tril(gL - Wt @ gW @ Wt)
        P = L.transpose(-1, -2) @ Lbar
        P = torch.tril(P) - 0.5 * torch.diag_embed(torch.diagonal(P, dim1=-2, dim2=-1))
        X = Wt @ P @ W
        return 0.5 * (X + X.transpose(-1, -2)), None, None


def ladder_factor_inv(K: torch.Tensor, rungs: tuple = LADDER, base_jitter: float = 1e-6):
    """``batched_ladder_factor`` of a (B, N, N) batch as a differentiable
    function: (L, W = L⁻¹, ok), with gradients to K through L and W."""
    return _LadderFactorInv.apply(K, tuple(rungs), base_jitter)


class _MaskedNLLBatched(torch.autograd.Function):
    """(B,) masked NLL over (B, N, N) systems; α = Wᵀ(W r) and the backward
    S⁻¹ = WᵀW are batched matmuls on the cached W = L⁻¹ (chol.py:216-271)."""

    @staticmethod
    def forward(ctx, Kt, r, n_act, rungs, base_jitter):
        L, W, ok = batched_ladder_factor(Kt, rungs, base_jitter)
        okb = ok[:, None, None]
        eye = torch.eye(Kt.shape[-1], dtype=Kt.dtype, device=Kt.device)
        Ls = torch.where(okb, L, eye)
        Ws = torch.where(okb, W, torch.zeros_like(W))
        alpha = Ws.transpose(-1, -2) @ (Ws @ r)
        quad = (r * alpha).sum((-2, -1))
        logdet = 2.0 * torch.log(torch.diagonal(Ls, dim1=-2, dim2=-1)).sum(-1)
        val = 0.5 * (quad + logdet + n_act * math.log(2.0 * math.pi))
        val = torch.where(ok, val, torch.full_like(val, 1e10))
        ctx.save_for_backward(Ws, alpha, ok)
        return val

    @staticmethod
    def backward(ctx, g):
        W, alpha, ok = ctx.saved_tensors
        Sinv = W.transpose(-1, -2) @ W
        aaT = alpha @ alpha.transpose(-1, -2)
        gb = torch.where(ok, g, torch.zeros_like(g))[:, None, None]
        return 0.5 * (Sinv - aaT) * gb, alpha * gb, None, None, None


def make_masked_nll_batched(rungs: tuple, base_jitter: float = 1e-6):
    """Batched masked NLL ``f(Kt (B,N,N), r (B,N,1), n_act (B,)) → (B,)``."""
    return lambda Kt, r, n_act: _MaskedNLLBatched.apply(
        Kt, r, n_act, tuple(rungs), base_jitter
    )
