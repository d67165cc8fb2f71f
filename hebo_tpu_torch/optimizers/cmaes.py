"""CMA-ES with restarts (port of ``hebo_tpu/optimizers/cmaes.py``): the
full rank-μ update with evolution-path cumulation and step-size control,
restarted on a non-finite covariance or a step outside [1e-9, 1e6], bounds
handled by reflection.  Sampling and the generation update are plain
PyTorch in float32 on the optimizer's device over fixed (λ, D) shapes.
``torch.linalg.eigh`` takes ``jnp.linalg.eigh``'s place (the JAX package
computes the eigendecomposition outside any Pallas kernel, :51, :86); it
is the port's one library eigensolver.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import AbstractOptimizer

__all__ = ["CMAES"]


class CMAState(NamedTuple):
    mean: torch.Tensor  # (D,)
    sigma: torch.Tensor  # ()
    C: torch.Tensor  # (D, D)
    p_sigma: torch.Tensor  # (D,)
    p_c: torch.Tensor  # (D,)
    count: torch.Tensor  # () generations


def _init_state(D: int, mean, sigma: float, device) -> CMAState:
    f32 = dict(dtype=torch.float32, device=device)
    return CMAState(mean=torch.as_tensor(np.asarray(mean, np.float32), **f32),
                    sigma=torch.tensor(sigma, **f32), C=torch.eye(D, **f32),
                    p_sigma=torch.zeros(D, **f32), p_c=torch.zeros(D, **f32),
                    count=torch.tensor(0, dtype=torch.int32, device=device))


def _cma_sample(state: CMAState, lam: int, lb: torch.Tensor, ub: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """λ candidates ~ N(m, σ²C), reflected into [lb, ub]; ``z`` (λ, D)
    replaces the generator's standard normals."""
    D = state.mean.shape[0]
    w, d = torch.linalg.eigh(state.C)
    B = d * torch.sqrt(torch.clamp(w, min=1e-12))[None, :]  # C^(1/2)
    if z is None:
        z = torch.randn((lam, D), generator=generator, dtype=torch.float32,
                        device=state.mean.device)
    x = state.mean[None, :] + state.sigma * (z @ B.T)
    span = ub - lb
    x = torch.where(x < lb, lb + torch.minimum(lb - x, span), x)
    x = torch.where(x > ub, ub - torch.minimum(x - ub, span), x)
    return torch.minimum(torch.maximum(x, lb), ub)


def _cma_update(state: CMAState, X: torch.Tensor, y: torch.Tensor, lam: int,
                mu: int) -> CMAState:
    """One generation's update from λ evaluated candidates X (λ, D), y (λ, 1)
    (Hansen's tutorial weights and constants)."""
    D = state.mean.shape[0]
    dev = state.mean.device
    w = math.log(mu + 0.5) - torch.log(torch.arange(1, mu + 1, dtype=torch.float32, device=dev))
    w = w / w.sum()
    mu_eff = 1.0 / (w ** 2).sum()
    c_sigma = (mu_eff + 2.0) / (D + mu_eff + 5.0)
    d_sigma = 1.0 + 2.0 * torch.clamp(torch.sqrt((mu_eff - 1.0) / (D + 1.0)) - 1.0, min=0.0) + c_sigma
    c_c = (4.0 + mu_eff / D) / (D + 4.0 + 2.0 * mu_eff / D)
    c_1 = 2.0 / ((D + 1.3) ** 2 + mu_eff)
    c_mu = torch.minimum(1.0 - c_1, 2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((D + 2.0) ** 2 + mu_eff))
    chi_n = math.sqrt(D) * (1.0 - 1.0 / (4.0 * D) + 1.0 / (21.0 * D ** 2))

    order = torch.argsort(y[:, 0], stable=True)[:mu]
    Xb = X[order]
    old_mean = state.mean
    mean = (w[:, None] * Xb).sum(0)

    evals, evecs = torch.linalg.eigh(state.C)
    evals = torch.clamp(evals, min=1e-12)
    C_isqrt = (evecs / torch.sqrt(evals)[None, :]) @ evecs.T

    y_w = (mean - old_mean) / state.sigma
    p_sigma = ((1.0 - c_sigma) * state.p_sigma
               + torch.sqrt(c_sigma * (2.0 - c_sigma) * mu_eff) * (C_isqrt @ y_w))
    ps_norm = torch.linalg.vector_norm(p_sigma)
    sigma = state.sigma * torch.exp((c_sigma / d_sigma) * (ps_norm / chi_n - 1.0))

    h_sigma = (ps_norm / torch.sqrt(1.0 - (1.0 - c_sigma) ** (2.0 * (state.count + 1.0)))
               < (1.4 + 2.0 / (D + 1.0)) * chi_n).to(torch.float32)
    p_c = (1.0 - c_c) * state.p_c + h_sigma * torch.sqrt(c_c * (2.0 - c_c) * mu_eff) * y_w

    dX = (Xb - old_mean[None, :]) / state.sigma
    rank_mu = torch.einsum("k,ki,kj->ij", w, dX, dX)
    C = ((1.0 - c_1 - c_mu) * state.C
         + c_1 * (torch.outer(p_c, p_c) + (1.0 - h_sigma) * c_c * (2.0 - c_c) * state.C)
         + c_mu * rank_mu)
    C = 0.5 * (C + C.T)
    return CMAState(mean, sigma, C, p_sigma, p_c, state.count + 1)


class CMAES(AbstractOptimizer):
    """Ask/tell CMA-ES over the continuous opt frame (discrete columns are
    rounded on the way out); a suggest with no count asks for one whole
    generation of λ."""

    support_parallel_opt = True

    def __init__(self, space, lam: Optional[int] = None, sigma0: float = 0.3,
                 csv_save_path: Optional[str] = None, device="cuda"):
        super().__init__(space, csv_save_path)
        self.device = resolve_device(device)
        D = space.num_cols
        self.lam = lam if lam is not None else 4 + int(3 * math.log(D))
        self.mu = self.lam // 2
        self.lb = torch.as_tensor(space.opt_lb, dtype=torch.float32, device=self.device)
        self.ub = torch.as_tensor(space.opt_ub, dtype=torch.float32, device=self.device)
        self.sigma0 = sigma0 * float(np.mean(np.asarray(space.opt_ub - space.opt_lb)))
        self._restart()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        self._pending: Optional[np.ndarray] = None
        self.n_restarts = 0

    def _restart(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        sp = self.space
        mean = np.asarray(sp.opt_lb + rng.random(sp.num_cols) * (sp.opt_ub - sp.opt_lb))
        self.state = _init_state(sp.num_cols, mean, self.sigma0, self.device)

    def suggest(self, n_suggestions=None, fix_input=None):
        return super().suggest(n_suggestions, fix_input)

    def method_suggest(self, n_suggestions=None, fix_input=None):
        n = self.lam if n_suggestions is None else n_suggestions
        X = _cma_sample(self.state, n, self.lb, self.ub, self._gen).cpu().numpy()
        self._pending = X
        return self.space.inverse_transform(self.space.round_opt(X))

    def observe_new_data(self, Xdf, y):
        if self._pending is None or len(Xdf) < self.mu:
            return
        X = torch.as_tensor(self._pending[: len(Xdf)], dtype=torch.float32, device=self.device)
        yv = np.asarray(y[:, :1], np.float32)
        fin = np.isfinite(yv)
        yv[~fin] = np.nanmax(yv[fin]) if fin.any() else 0.0
        self.state = _cma_update(self.state, X, torch.as_tensor(yv, device=self.device),
                                 len(Xdf), self.mu)
        self._pending = None
        # restart on a degenerate covariance or a vanishing / exploding step
        sig = float(self.state.sigma)
        if not bool(torch.isfinite(self.state.C).all()) or sig < 1e-9 or sig > 1e6:
            self.n_restarts += 1
            self._restart(seed=self.n_restarts)
