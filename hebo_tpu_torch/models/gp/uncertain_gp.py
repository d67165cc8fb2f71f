"""Uncertain-input GP (AIRBO; port of ``hebo_tpu/models/gp/uncertain_gp.py``).

Each design x is the distribution N(x, diag(σ_in²)) in the scaled feature
frame; the kernel is the closed-form expected RBF between two such inputs,

    E[k(x, x')] = Π_d ℓ_d / √(ℓ_d² + s1_d² + s2_d²)
                  · exp(−½ (m1_d − m2_d)² / (ℓ_d² + s1_d² + s2_d²)),

and ``prior_diag`` is its value at x = x' (below the outputscale).
``mmd_nystrom_kernel`` is AIRBO's MMD kernel between empirical sample sets
through a Nyström feature map; its Kmm^{-1/2} comes from
``torch.linalg.eigh`` at (m, m), computed, as in the JAX package
(uncertain_gp.py:69), outside any kernel.  Both are plain PyTorch: the JAX
package computes them outside any Pallas kernel.  The fit and the
posterior are the exact GP's (Adam, 100 epochs; kernel K1's ladder).
"""

from __future__ import annotations

import torch

from ..base import register_model
from .gp import GP, GPCore

__all__ = ["expected_rbf", "mmd_nystrom_kernel", "UncertainGPCore", "UncertainGP"]


def expected_rbf(x1: torch.Tensor, x2: torch.Tensor, lengthscales: torch.Tensor,
                 in_std1: torch.Tensor, in_std2: torch.Tensor) -> torch.Tensor:
    """Expected RBF between Gaussian inputs: x1 (..., N, D), x2 (..., M, D),
    lengthscales and input stds broadcastable to (..., D)."""
    l2 = lengthscales ** 2
    denom = l2 + in_std1 ** 2 + in_std2 ** 2  # (..., D)
    pref = torch.prod(torch.sqrt(l2 / denom), -1)
    d2 = ((x1[..., :, None, :] - x2[..., None, :, :]) ** 2 / denom[..., None, None, :]).sum(-1)
    return pref[..., None, None] * torch.exp(-0.5 * d2)


def mmd_nystrom_kernel(S1: torch.Tensor, S2: torch.Tensor, landmarks: torch.Tensor,
                       gamma: float, feat_ls: float) -> torch.Tensor:
    """exp(−MMD²(P, Q) / (2γ²)) between sample sets S1 (N, s, D) and
    S2 (M, s, D), the MMD from the mean Nyström features φ(x) =
    Kmm^{-1/2} k_m(x) over the landmarks (m, D)."""
    m = landmarks.shape[0]

    def rbf(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return torch.exp(-0.5 * d2 / feat_ls ** 2)

    Kmm = rbf(landmarks, landmarks) + 1e-5 * torch.eye(m, dtype=landmarks.dtype,
                                                      device=landmarks.device)
    w, V = torch.linalg.eigh(Kmm)
    W = V / torch.sqrt(torch.clamp(w, min=1e-8))[None, :]  # Kmm^{-1/2} factor

    def mean_feat(S):
        phi = rbf(S.reshape(-1, S.shape[-1]), landmarks) @ W  # (N·s, m)
        return phi.reshape(S.shape[0], S.shape[1], m).mean(1)

    F1, F2 = mean_feat(S1), mean_feat(S2)
    d2 = (F1 ** 2).sum(-1)[:, None] + (F2 ** 2).sum(-1)[None, :] - 2.0 * F1 @ F2.T
    return torch.exp(-0.5 * torch.clamp(d2, min=0.0) / gamma ** 2)


class UncertainGPCore(GPCore):
    """GP core whose numeric kernel is the expected RBF over
    N(x, diag(σ_in²)) inputs in the scaled frame."""

    def __init__(self, *args, input_std: float = 0.05, **kw):
        kw.setdefault("kernel", "rbf")
        super().__init__(*args, **kw)
        self.input_std = input_std

    def gram_points(self, params, X1, X2, data):
        f1 = self.features(params, X1, data)
        f2 = self.features(params, X2, data)
        ls = torch.exp(params.log_ls[:, : self.n_feat_dims])
        s_in = torch.full((self.n_feat_dims,), self.input_std, dtype=f1.dtype, device=f1.device)
        return torch.exp(params.log_sc)[:, None, None] * expected_rbf(f1, f2, ls, s_in, s_in)

    def prior_diag(self, params):
        """(B,) E[k(x, x)] = σ² Π_d √(ℓ_d² / (ℓ_d² + 2 s²))."""
        ls2 = torch.exp(2.0 * params.log_ls[:, : self.n_feat_dims])
        s2 = self.input_std ** 2
        return torch.exp(params.log_sc) * torch.prod(torch.sqrt(ls2 / (ls2 + 2.0 * s2)), -1)


@register_model("uncertain_gp")
class UncertainGP(GP):
    """AIRBO's surrogate: the expected-RBF GP under Gaussian input noise
    ``input_std`` (0.05 in the scaled frame)."""

    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        super().__init__(space, num_out=num_out, device=device, **conf)
        self.core = UncertainGPCore(
            numeric_dims=tuple(space.numeric_dims) + tuple(space.perm_dims),
            cat_dims=tuple(space.cat_dims),
            num_categories=tuple(int(space.num_categories[c]) for c in space.cat_dims),
            optimizer=conf.get("optimizer", "adam"),
            n_steps=conf.get("num_epochs", 100),
            lr=conf.get("lr", 0.05),
            n_ensemble=conf.get("n_ensemble", 1),
            input_std=conf.get("input_std", 0.05),
        )
