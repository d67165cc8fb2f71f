"""GP kernel pieces as batched tensor functions.

Port of ``hebo_tpu/models/gp/kernels.py``: ``sq_dist`` (:46), the
stationary kernels ``matern12``, ``matern32``, ``matern52``, ``rbf`` and the
arc-sine ``mlp`` (:61-100) with their ``MATERN_FNS`` table (:102),
``embed_categorical`` (:108), ``overlap`` (:131), ``transformed_overlap``
(:141), ``conditional_transformed_overlap`` (:155), ``ordinal_kernel``
(:198), ``diffusion_kernel`` (:210), ``ssk_kernel`` (:234), ``hed_embed``
(:278), ``feature_warp_rbf`` (:294) and ``feature_warp_cosine`` (:315).  Distances use the expansion
‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b, as in the JAX package, with the +1e-16 inside
each square root, so the gradients at d = 0 are the JAX package's.

The kernels take point sets (..., N, D), (..., M, D) and lengthscales
(..., D) with the same leading (batch) shape and return (..., N, M).  The
Matérn-3/2 Gram goes through kernel K2 (``hebo_tpu_torch.ops.gram``) and the
SSK Gram through kernel K3 (``hebo_tpu_torch.ops.ssk``).  The JAX package
has no Pallas kernel for the others (it uses its Pallas Gram only for
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
    "embed_categorical", "overlap", "transformed_overlap", "conditional_transformed_overlap",
    "ordinal_kernel", "diffusion_kernel", "ssk_kernel", "hed_embed", "feature_warp_rbf",
    "feature_warp_cosine",
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


def conditional_transformed_overlap(c1: torch.Tensor, c2: torch.Tensor,
                                    group_grams: torch.Tensor, cat_to_group: torch.Tensor,
                                    lam: torch.Tensor) -> torch.Tensor:
    """Conditional (hierarchical) transformed overlap, normalised so
    k(x, x) = 1: per dimension 0 on a category mismatch, 1 on a match whose
    category has no hyperparameters, and the matched category's group Gram
    otherwise; the ARD-weighted mean is exponentiated, exp(s − 1).

    Codes c1 (N1, C), c2 (N2, C); ``group_grams`` (..., G, N1, N2);
    ``cat_to_group`` (n_cats,) int, −1 for a category without
    hyperparameters; ``lam`` (..., C) positive → (..., N1, N2)."""
    N1, C = c1.shape
    N2 = c2.shape[0]
    c1i = c1.long()
    match = c1i[:, None, :] == c2.long()[None, :, :]  # (N1, N2, C)
    g = cat_to_group.long()[c1i]  # (N1, C)
    moved = group_grams.movedim(-3, -1)  # (..., N1, N2, G)
    idx = g.clamp(min=0)[:, None, :].expand(N1, N2, C)
    picked = torch.gather(moved, -1, idx.expand(moved.shape[:-3] + (N1, N2, C)))
    one = torch.ones((), dtype=picked.dtype, device=picked.device)
    sim = torch.where(match, torch.where((g >= 0)[:, None, :], picked, one), torch.zeros_like(one))
    s = (sim * lam[..., None, None, :]).sum(-1) / torch.clamp(lam.sum(-1), min=1e-12)[..., None, None]
    return torch.exp(s - 1.0)


def ordinal_kernel(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                   num_values: torch.Tensor) -> torch.Tensor:
    """exp(mean_d θ_d·(1 − |x1_d − x2_d| / max(n_d − 1, 1)) − mean_d θ_d)
    over ordinal codes (N, C), (M, C) → (N, M)."""
    diff = (x1[:, None, :] - x2[None, :, :]).abs() / torch.clamp(num_values - 1.0, min=1.0)
    s = ((1.0 - diff) * lengthscales).mean(-1)
    return torch.exp(s - lengthscales.mean())


def diffusion_kernel(x1: torch.Tensor, x2: torch.Tensor, betas: torch.Tensor,
                     num_categories: torch.Tensor) -> torch.Tensor:
    """Product over the categorical dims of the complete-graph diffusion
    kernel (COMBO's closed form): 1 where the codes agree, else
    (1 − e^{−cβ}) / (1 + (c − 1)e^{−cβ}) for cardinality c and decay β.

    Codes (N, C), (M, C); ``betas`` (C,) → (N, M), or (B, C) → (B, N, M)."""
    c = num_categories.to(betas.dtype)
    e = torch.exp(-c * betas)  # (..., C)
    same_val = (1.0 + (c - 1.0) * e) / (1.0 + (c - 1.0) * e)  # = 1, as in the JAX package
    diff_val = (1.0 - e) / (1.0 + (c - 1.0) * e)
    agree = x1[:, None, :] == x2[None, :, :]
    per_dim = torch.where(agree, same_val[..., None, None, :], diff_val[..., None, None, :])
    return per_dim.prod(-1)


def hed_embed(codes: torch.Tensor, dictionary: torch.Tensor) -> torch.Tensor:
    """Hamming embedding: the mean agreement of codes (N, C) with each of the
    m dictionary anchors (m, C) → (N, m)."""
    return (codes[:, None, :] == dictionary[None, :, :]).to(torch.float32).mean(-1)


def feature_warp_rbf(idx1: torch.Tensor, idx2: torch.Tensor, feature_table: torch.Tensor,
                     lengthscales: torch.Tensor) -> torch.Tensor:
    """RBF over the rows ``idx1`` (N,), ``idx2`` (M,) of a precomputed
    feature table (table_size, F) → (N, M)."""
    return rbf(feature_table[idx1.long()], feature_table[idx2.long()], lengthscales)


def feature_warp_cosine(idx1: torch.Tensor, idx2: torch.Tensor,
                        feature_table: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of the feature-table rows ``idx1``, ``idx2``, each
    norm floored at 1e-6 (its square at 1e-12) → (N, M)."""
    f1, f2 = feature_table[idx1.long()], feature_table[idx2.long()]
    n1 = torch.sqrt(torch.clamp((f1 * f1).sum(-1, keepdim=True), min=1e-12))
    n2 = torch.sqrt(torch.clamp((f2 * f2).sum(-1, keepdim=True), min=1e-12))
    return (f1 / n1) @ (f2 / n2).transpose(0, 1)


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
