"""GP kernel pieces as batched tensor functions.

Port of ``hebo_tpu/models/gp/kernels.py``: ``sq_dist`` (:46), ``matern32``
(:66), ``embed_categorical`` (:108), ``overlap`` (:131),
``transformed_overlap`` (:141) and ``ssk_kernel`` (:234).  Distances use the
expansion ‖a−b‖² = ‖a‖² + ‖b‖² − 2a·b, as in the JAX package.  The
Matérn-3/2 Gram of the GP goes through kernel K2 (``hebo_tpu_torch.ops.gram``)
and its SSK Gram through kernel K3 (``hebo_tpu_torch.ops.ssk``); ``matern32``
and ``ssk_kernel`` here are plain forms for callers and tests.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.gram import matern32_gram
from ...ops.ssk import ssk_gram_plain

__all__ = [
    "sq_dist", "matern32", "embed_categorical", "overlap", "transformed_overlap", "ssk_kernel",
]


def sq_dist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance (..., N, D), (..., M, D) → (..., N, M),
    clamped at 0."""
    n1 = (x1 * x1).sum(-1)[..., :, None]
    n2 = (x2 * x2).sum(-1)[..., None, :]
    return torch.clamp(n1 + n2 - 2.0 * (x1 @ x2.transpose(-1, -2)), min=0.0)


def matern32(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor) -> torch.Tensor:
    """Unit-outputscale Matérn-3/2 of (N, D) and (M, D) point sets."""
    a = (x1 / lengthscales)[None].contiguous()
    b = (x2 / lengthscales)[None].contiguous()
    sc = torch.ones(1, dtype=a.dtype, device=a.device)
    return matern32_gram(a, b, sc)[0]


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
