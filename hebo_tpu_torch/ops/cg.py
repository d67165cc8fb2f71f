"""Large-N GP solves: pivoted-Cholesky-preconditioned conjugate gradients.

Port of ``hebo_tpu/ops/cg.py``.  Above ``max_cholesky_size`` the GP keeps
all its data in the posterior and replaces the dense O(N³) factorization
with matrix-free solves:

* ``pivoted_cholesky``: rank-k partial Cholesky with greedy diagonal
  pivoting (the GPyTorch/Harbrecht preconditioner), k rank-1 steps;
* ``woodbury_precond_apply``: ``(P Pᵀ + δ I)⁻¹`` through the Woodbury
  identity and a k×k Cholesky, whose factor L and W = L⁻¹ kernel K1
  computes on CUDA (``woodbury_factor``);
* ``pcg_solve``: block preconditioned CG on ``K X = B`` with a fixed
  iteration count; a per-column mask freezes the converged columns.

Every function takes a leading sample axis S (which the JAX package maps
with ``vmap``) and runs as batched matmuls.  The JAX package has no Pallas
kernel here, so these are plain PyTorch, apart from the k×k factorization.
The JAX package solves that factor's two triangular systems at every
apply (``cho_solve``); here ``Q = P Wᵀ`` is made once per factor, so that
an apply is two matmuls, as the dense route's cached W = L⁻¹ replaces its
triangular solves (gp.py:786-789).  Nothing reads a
device value on the host: the loops always run their full count, ties in
the pivot search go to the first index (``argmax``), as in JAX, and on
CUDA the loop could sit in a captured graph.  The products are float32
with TF32 off (``utils.device.resolve_device``; ``pcg_solve`` checks it):
TF32 would change the result of a solve that already stalls near 1e-2
relative residual in float32 on small-noise systems.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from .chol_kernel import chol_inv

__all__ = ["pivoted_cholesky", "woodbury_factor", "woodbury_precond_apply", "pcg_solve"]


def pivoted_cholesky(K: torch.Tensor, rank: int, jitter: float = 1e-6) -> torch.Tensor:
    """Rank-``rank`` pivoted partial Cholesky of PSD ``K`` (S, N, N).

    Returns ``P`` (S, N, rank) with ``K ≈ P Pᵀ`` (cg.py:36-60): at step i
    the pivot j is the largest residual diagonal entry, and column i is the
    residual row j of K over √d_j, with √d_j at j (the column's largest
    entry)."""
    S, N, _ = K.shape
    d = torch.diagonal(K, dim1=-2, dim2=-1).clone()
    P = K.new_zeros((S, N, rank))
    for i in range(rank):
        j = torch.argmax(d, dim=-1, keepdim=True)  # (S, 1)
        dj = torch.clamp(d.gather(-1, j), min=jitter)
        Kj = K.gather(1, j[:, :, None].expand(S, 1, N))  # (S, 1, N): row j
        Pj = P.gather(1, j[:, :, None].expand(S, 1, rank))  # (S, 1, rank)
        row = Kj[:, 0] - (P @ Pj.transpose(-1, -2))[..., 0]
        sq = torch.sqrt(dj)
        col = (row / sq).scatter(-1, j, sq)
        d = torch.clamp(d - col * col, min=0.0).scatter(-1, j, 0.0)
        P[:, :, i] = col
    return P


def woodbury_factor(P: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """``Q = P Wᵀ`` (S, N, k), where W = L⁻¹ for the lower Cholesky factor L
    of ``δ I + PᵀP + 1e-6 I`` (cg.py:68-70), so that
    ``Q Qᵀ = P (δ I + PᵀP + 1e-6 I)⁻¹ Pᵀ``; NaN where the factorization
    fails.  L and W come from ``chol_inv`` (kernel K1 on CUDA)."""
    k = P.shape[-1]
    eye = torch.eye(k, dtype=P.dtype, device=P.device)
    A = delta[:, None, None] * eye + P.transpose(-1, -2) @ P
    _, W = chol_inv((A + 1e-6 * eye).contiguous())
    return P @ W.transpose(-1, -2)


def woodbury_precond_apply(P: torch.Tensor, delta: torch.Tensor, Q: torch.Tensor):
    """``apply(B) = (P Pᵀ + δ I)⁻¹ B`` for B (S, N, R), per sample:
    ``(B − P (δ I + PᵀP)⁻¹ Pᵀ B) / δ = (B − Q (Qᵀ B)) / δ`` (cg.py:63-76),
    with ``Q = woodbury_factor(P, delta)``."""
    Qt = Q.transpose(-1, -2)
    d = delta[:, None, None]

    def apply(B):
        return torch.baddbmm(B, Q, Qt @ B, alpha=-1.0) / d

    return apply


def pcg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    *,
    precond_apply: Optional[Callable] = None,
    n_iters: int = 64,
    tol: float = 1e-5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block preconditioned CG: solve ``K X = B`` for B (S, N, R)
    (cg.py:79-121).

    Always ``n_iters`` iterations; a column whose relative residual is at
    most ``tol`` takes no further step.  Returns (X (S, N, R), the final
    relative residual norms (S, R))."""
    if B.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("pcg_solve: TF32 matmuls are on; the CG path runs in full float32")
    Mi = precond_apply if precond_apply is not None else (lambda x: x)
    X = torch.zeros_like(B)
    Rr = B
    Z = Mi(Rr)
    Pd = Z
    rz = (Rr * Z).sum(-2)  # (S, R)
    b_norm = torch.clamp(torch.linalg.vector_norm(B, dim=-2), min=1e-30)
    for _ in range(n_iters):
        KP = matvec(Pd)
        denom = (Pd * KP).sum(-2)
        active = torch.linalg.vector_norm(Rr, dim=-2) / b_norm > tol
        alpha = torch.where(denom > 0, rz / torch.clamp(denom, min=1e-30), 0.0)
        alpha = torch.where(active, alpha, 0.0)[:, None, :]
        X = torch.addcmul(X, alpha, Pd)
        Rr = torch.addcmul(Rr, alpha, KP, value=-1.0)
        Z = Mi(Rr)
        rz_new = (Rr * Z).sum(-2)
        beta = torch.where(rz > 0, rz_new / torch.clamp(rz, min=1e-30), 0.0)
        Pd = torch.addcmul(Z, beta[:, None, :], Pd)
        rz = rz_new
    return X, torch.linalg.vector_norm(Rr, dim=-2) / b_norm
