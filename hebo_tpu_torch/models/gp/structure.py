"""Data-driven decomposition structure learning (port of
``hebo_tpu/models/gp/structure.py``, RDUCB ``learnDependencyStructure``).

Each dimension's group id z_j is resampled by the Gumbel-max trick with
scores = the additive GP's data log-likelihood of the candidate assignment,
under a max-group-size cap; the best-likelihood assignment over all sweeps
wins.  The per-dimension log-kernels are computed once as a (D, N, N)
stack, and one move scores all M candidate groups of a dimension with one
batched jitter-ladder factorization at (M, N) (kernel K1 on CUDA): α and
the log-determinant come from W = L⁻¹ and diag(L), where the JAX package
calls ``safe_cholesky``, ``solve_triangular`` and ``chol_logdet``
(structure.py:100-104).  The Gibbs sweep is a Python loop over
``n_sweeps · D`` moves with no host read: the argmax, the feasibility mask
and the best-so-far update stay on the device.  Its random numbers (the
initial permutation and each move's M Gumbels) come from a generator or
are passed in (``draws``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from ...ops.chol import LADDER, batched_ladder_factor

__all__ = ["dim_log_kernels", "assignment_mll", "move_mlls", "learn_assignment",
           "assignment_to_cliques"]

_LOG2PI = math.log(2.0 * math.pi)


def dim_log_kernels(X: torch.Tensor, x_lb: torch.Tensor, x_span: torch.Tensor,
                    numeric_dims: Tuple[int, ...], cat_dims: Tuple[int, ...],
                    lengthscale: float = 0.3) -> torch.Tensor:
    """(D, N, N) per-dimension log-kernels (structure.py:45-70): Matérn-5/2
    on the min-max-scaled numerics at a fixed lengthscale, agree − 1 (the
    log of the exp-agreement kernel at θ = 1) on the categoricals."""
    D = X.shape[1]
    lb = X.new_zeros(D)
    span = X.new_ones(D)
    if numeric_dims:
        nd = torch.as_tensor(numeric_dims, device=X.device)
        lb = lb.index_copy(0, nd, x_lb)
        span = span.index_copy(0, nd, x_span)
    cols = X.transpose(0, 1)  # (D, N)
    s = (cols - lb[:, None]) / span[:, None]
    diff = torch.abs(s[:, :, None] - s[:, None, :]) / lengthscale
    r = math.sqrt(5.0) * diff
    num = torch.log(1.0 + r + 5.0 * diff ** 2 / 3.0) - r
    cat = (cols[:, :, None] == cols[:, None, :]).to(X.dtype) - 1.0
    is_cat = torch.zeros(D, dtype=torch.bool, device=X.device)
    if cat_dims:
        is_cat[list(cat_dims)] = True
    return torch.where(is_cat[:, None, None], cat, num)


def _mll(K: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, noise: float) -> torch.Tensor:
    """(B,) masked marginal log-likelihood of the GPs with Grams K (B, N, N)
    (structure.py:96-105): padded rows and columns become the identity;
    one ladder factorization of the batch, α = W y and log|K| from diag L."""
    n = K.shape[-1]
    m = mask.to(K.dtype)
    m2 = m[:, None] * m[None, :]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    Kt = K * m2 + (1.0 - m2) * eye + noise * eye
    L, W, ok = batched_ladder_factor(Kt, LADDER)
    ym = (y[:, 0] * m)[:, None]
    a = W @ ym
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    mll = -0.5 * (a * a).sum((-2, -1)) - logdet - 0.5 * m.sum() * _LOG2PI
    return torch.where(ok, mll, torch.full_like(mll, -math.inf))


def assignment_mll(z: torch.Tensor, Ld: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                   M: int, noise: float = 1e-2) -> torch.Tensor:
    """Marginal log-likelihood of the additive GP of the assignment z (D,)
    (structure.py:73-106): K = Σ_m [group m nonempty] exp(Σ_{d: z_d = m}
    Ld[d]) / n_groups."""
    Z = torch.nn.functional.one_hot(z.long(), M).to(Ld.dtype)  # (D, M)
    S = torch.einsum("dm,dij->mij", Z, Ld)
    nonempty = (Z.sum(0) > 0).to(Ld.dtype)
    K = torch.einsum("m,mij->ij", nonempty, torch.exp(S)) / torch.clamp(nonempty.sum(), min=1.0)
    return _mll(K[None], y, mask, noise)[0]


def move_mlls(z: torch.Tensor, j: int, Ld: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
              M: int, noise: float = 1e-2) -> torch.Tensor:
    """(M,) ``assignment_mll`` of z with z[j] set to each group m, from one
    (M, N, N) factorization: with dimension j left out, group m' holds the
    log-Gram S_m'; candidate m's Gram is the sum of the other nonempty
    groups' exp(S_m') (exclusive prefix + suffix sums, no cancellation) and
    exp(S_m + Ld[j]), over the candidate's group count."""
    D = Ld.shape[0]
    keep = (torch.arange(D, device=Ld.device) != j).to(Ld.dtype)
    Z = torch.nn.functional.one_hot(z.long(), M).to(Ld.dtype) * keep[:, None]
    S = torch.einsum("dm,dij->mij", Z, Ld)
    ne = (Z.sum(0) > 0).to(Ld.dtype)
    E = ne[:, None, None] * torch.exp(S)
    zero = torch.zeros_like(E[:1])
    pre = torch.cat([zero, torch.cumsum(E, 0)[:-1]], 0)
    suf = torch.cat([torch.flip(torch.cumsum(torch.flip(E, (0,)), 0), (0,))[1:], zero], 0)
    groups = ne.sum() + (1.0 - ne)
    K = (pre + suf + torch.exp(S + Ld[j])) / groups[:, None, None]
    return _mll(K, y, mask, noise)


def learn_assignment(X: torch.Tensor, y: torch.Tensor, mask: torch.Tensor, x_lb: torch.Tensor,
                     x_span: torch.Tensor, numeric_dims: Tuple[int, ...],
                     cat_dims: Tuple[int, ...], M: int = 4, max_group_size: int = 3,
                     n_sweeps: int = 2, noise: float = 1e-2,
                     generator: Optional[torch.Generator] = None,
                     draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Gibbs sweeps over group assignments (structure.py:109-170); returns
    (z_best (D,), mll_best ()) on the device.

    ``draws`` = (perm (D,), gumbels (n_sweeps·D, M)) replaces the
    generator's: the feasible-by-construction initial assignment puts
    perm[i] in group i mod M, and move i scores dimension i mod D."""
    D = X.shape[1]
    dev = X.device
    Ld = dim_log_kernels(X, x_lb, x_span, numeric_dims, cat_dims)
    if draws is None:
        perm = torch.randperm(D, generator=generator, device=dev)
        u = torch.rand((n_sweeps * D, M), generator=generator, device=dev)
        tiny = torch.finfo(torch.float32).tiny
        gumbels = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    else:
        perm, gumbels = (torch.as_tensor(t, device=dev) for t in draws)
        gumbels = gumbels.to(torch.float32)
    ar = torch.arange(D, device=dev)
    z = torch.zeros(D, dtype=torch.int64, device=dev).index_copy(0, perm.long(), ar % M)
    best_z, best_mll = z, assignment_mll(z, Ld, y, mask, M, noise)
    for i in range(n_sweeps * D):
        j = i % D
        counts = torch.nn.functional.one_hot(z, M).sum(0)
        sizes = counts - torch.nn.functional.one_hot(z[j], M)
        feasible = sizes + 1 <= max_group_size
        scores = move_mlls(z, j, Ld, y, mask, M, noise)
        noisy = torch.where(feasible, scores + gumbels[i], torch.full_like(scores, -math.inf))
        m_new = torch.argmax(noisy)
        z = torch.where(ar == j, m_new, z)
        cur = scores.gather(0, m_new.reshape(1))[0]
        better = cur > best_mll
        best_z = torch.where(better, z, best_z)
        best_mll = torch.where(better, cur, best_mll)
    return best_z, best_mll


def assignment_to_cliques(z: np.ndarray, M: int) -> List[Tuple[int, ...]]:
    """Host side: assignment vector → clique tuples (nonempty groups)."""
    out = []
    for m in range(M):
        dims = tuple(int(d) for d in np.nonzero(z == m)[0])
        if dims:
            out.append(dims)
    return out
