"""GP kernel pieces as batched tensor functions.

Port of ``hebo_tpu/models/gp/kernels.py``: ``sq_dist`` (:46), the
stationary kernels ``matern12``, ``matern32``, ``matern52``, ``rbf`` and the
arc-sine ``mlp`` (:61-100) with their ``MATERN_FNS`` table (:102),
``embed_categorical`` (:108), ``overlap`` (:131), ``transformed_overlap``
(:141) and ``ssk_kernel`` (:234).  Distances use the expansion
‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b, as in the JAX package, with the +1e-16 inside
each square root, so the gradients at d = 0 are the JAX package's.

The kernels take point sets (..., N, D), (..., M, D) and lengthscales
(..., D) with the same leading (batch) shape and return (..., N, M).  The
Matérn-3/2 Gram goes through kernel K2 (``hebo_tpu_torch.ops.gram``) and the
SSK Gram through kernel K3 (``hebo_tpu_torch.ops.ssk``).  The JAX package
has no Pallas kernel for the other four (it uses its Pallas Gram only for
``matern32``), so they are plain PyTorch on every device; on CUDA their
products run in full float32, since ``resolve_device`` turns TF32 off.
``ssk_kernel`` here is the plain form for callers and tests.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...ops.gram import matern32_gram
from ...ops.ssk import ssk_gram_plain

__all__ = [
    "sq_dist", "matern12", "matern32", "matern52", "rbf", "mlp", "MATERN_FNS",
    "embed_categorical", "overlap", "transformed_overlap", "ssk_kernel",
]


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance (..., N, D), (..., M, D) → (..., N, M),
    floored at 0 by ``maximum``, whose gradient at a tie is halved as in
    ``jnp.maximum``."""
    n1 = (x1 * x1).sum(-1)[..., :, None]
    n2 = (x2 * x2).sum(-1)[..., None, :]
    d2 = n1 + n2 - 2.0 * (x1 @ x2.transpose(-1, -2))
    return torch.maximum(d2, torch.zeros((), dtype=d2.dtype, device=d2.device))


def _scaled(x: torch.Tensor, lengthscales: torch.Tensor) -> torch.Tensor:
    return x / lengthscales.unsqueeze(-2)


def matern12(x1, x2, lengthscales):
    d = torch.sqrt(sq_dist(_scaled(x1, lengthscales), _scaled(x2, lengthscales)) + 1e-16)
    return torch.exp(-d)


def matern32(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor) -> torch.Tensor:
    """Unit-outputscale Matérn-3/2 through kernel K2 (its plain version on
    the CPU)."""
    a, b = _scaled(x1, lengthscales), _scaled(x2, lengthscales)
    single = a.dim() == 2
    a = (a[None] if single else a).contiguous()
    b = (b[None] if single else b).contiguous()
    K = matern32_gram(a, b, torch.ones(a.shape[0], dtype=a.dtype, device=a.device))
    return K[0] if single else K


def matern52(x1, x2, lengthscales):
    d2 = sq_dist(_scaled(x1, lengthscales), _scaled(x2, lengthscales))
    d = torch.sqrt(d2 + 1e-16)
    s = math.sqrt(5.0) * d
    return (1.0 + s + 5.0 * d2 / 3.0) * torch.exp(-s)


def rbf(x1, x2, lengthscales):
    return torch.exp(-0.5 * sq_dist(_scaled(x1, lengthscales), _scaled(x2, lengthscales)))


def mlp(x1, x2, lengthscales):
    """MLP (arc-sine) kernel, (2/π)·asin((zᵀz' + 1) / √((‖z‖²+2)(‖z'‖²+2)))
    with z = x/ℓ (ARD weight variances 1/ℓ², bias variance 1), the ratio
    clipped to ±(1 − 1e-7) with ``jnp.clip``'s tie gradients."""
    z1, z2 = _scaled(x1, lengthscales), _scaled(x2, lengthscales)
    b = 1.0
    num = z1 @ z2.transpose(-1, -2) + b
    d1 = (z1 * z1).sum(-1)[..., :, None] + b + 1.0
    d2 = (z2 * z2).sum(-1)[..., None, :] + b + 1.0
    r = num / torch.sqrt(d1 * d2)
    lo = torch.full((), -1.0 + 1e-7, dtype=r.dtype, device=r.device)
    hi = torch.full((), 1.0 - 1e-7, dtype=r.dtype, device=r.device)
    return (2.0 / math.pi) * torch.asin(torch.minimum(torch.maximum(r, lo), hi))


MATERN_FNS = {
    "matern12": matern12, "matern32": matern32, "matern52": matern52,
    "rbf": rbf, "mlp": mlp,
}


def embed_categorical(codes: torch.Tensor, emb_table: torch.Tensor,
                      cat_offsets: torch.Tensor) -> torch.Tensor:
    """Integer codes (N, C) → concatenated embeddings (..., N, C·E).

    ``emb_table`` is (total_cats, E) or batched (B, total_cats, E);
    ``cat_offsets`` (C,) is the first table row of each column.  The
    one-hot contraction is a matmul, as in the JAX package."""
    n, c = codes.shape
    total = emb_table.shape[-2]
    flat = codes.long() + cat_offsets.long()[None, :]
    onehot = F.one_hot(flat, total).to(emb_table.dtype)  # (N, C, total)
    emb = torch.einsum("nct,...te->...nce", onehot, emb_table)
    return emb.reshape(emb.shape[:-3] + (n, -1))


def overlap(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Mean category agreement (Hamming similarity) of codes (N, C) and
    (M, C) → (N, M) in [0, 1]."""
    return (x1[:, None, :] == x2[None, :, :]).to(torch.float32).mean(-1)


def transformed_overlap(x1: torch.Tensor, x2: torch.Tensor,
                        lengthscales: torch.Tensor) -> torch.Tensor:
    """exp(mean_d θ_d·1[x1_d = x2_d] − mean_d θ_d), so k(x, x) = 1.

    ``lengthscales`` θ is (C,) → (N, M), or batched (B, C) → (B, N, M)."""
    agree = (x1[:, None, :] == x2[None, :, :]).to(lengthscales.dtype)
    s = torch.einsum("nmc,...c->...nm", agree, lengthscales) / agree.shape[-1]
    return torch.exp(s - lengthscales.mean(-1)[..., None, None])


def ssk_kernel(s1: torch.Tensor, s2: torch.Tensor, match_decay, gap_decay,
               max_subseq: int = 3) -> torch.Tensor:
    """Normalised string-subsequence kernel, the plain dense form
    (``ops.ssk.ssk_gram_plain``) on any device.

    Codes s1 (N, L), s2 (M, L); decays scalars or (B,) → (N, M) or
    (B, N, M).  The GP's SSK Gram is ``ops.ssk.ssk_gram``."""
    md = torch.as_tensor(match_decay, dtype=torch.float32, device=s1.device)
    gd = torch.as_tensor(gap_decay, dtype=torch.float32, device=s1.device)
    K = ssk_gram_plain(s1, s2, md.reshape(-1), gd.reshape(-1), max_subseq)
    return K if md.dim() == 1 else K[0]
