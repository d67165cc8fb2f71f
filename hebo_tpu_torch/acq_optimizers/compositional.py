"""Compositional acquisition maximization (CompBO; port of
``hebo_tpu/acq_optimizers/compositional.py``).

Monte-Carlo q-EI in nested-expectation form, max_x g(E_w[h(x, w)]) with
h(x, w) = τ − f_w(x) and g a smoothed max(·, 0), maximised over the
opt-frame box by one of five optimizers: ``cadam`` / ``nasa`` (a running
estimate y_t ≈ E_w[h] and an Adam-style outer step), ``scgd`` / ``ascgd``
(stochastic compositional gradient, plain or accelerated steps) and
``adam`` (plain MC gradient, optax's Adam).  The posterior draws are
reparametrized, μ + σε, so the gradient in X is ``torch.autograd``'s
through the model's ``predict_pure`` (kernel K2's VJP in the query points
on CUDA).  The step loop reads nothing on the host.

The ε draws (``CompDraws``) come in one call per kind from a generator on
the model's device seeded with ``seed``, or are passed in: a test feeds
the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models.gp.tree import adam_step
from .mcbo_opts import AcqOptimizerBase

__all__ = ["CompositionalAcqOptimizer", "CompDraws"]

_METHODS = ("cadam", "scgd", "ascgd", "nasa", "adam")


class CompDraws(NamedTuple):
    """Standard normals (n_mc, P) per evaluation: ``init`` for y₀ (the
    compositional methods), ``steps`` (n_steps, 2, n_mc, P) for each step's
    two evaluations (``adam``: (n_steps, 1, n_mc, P)), ``final`` for the
    returned scores."""

    init: torch.Tensor
    steps: torch.Tensor
    final: torch.Tensor


def _draw(model, state, X, eps):
    """Reparametrized draws at X: (S, P) = μ + σε."""
    mu, var = model.predict_pure(state, X)
    sigma = torch.sqrt(torch.clamp(var, min=1e-12))
    return mu[None, :, 0] + eps * sigma[None, :, 0]


def _outer_g(u):
    """Smoothed max(u, 0), averaged over the draws → per-point q-EI."""
    return (torch.nn.functional.softplus(u * 12.0) / 12.0).mean(0)


class CompositionalAcqOptimizer(AcqOptimizerBase):
    """Maximise MC q-EI (negated → minimised) with a compositional
    stochastic optimizer over the continuous opt-frame box."""

    def __init__(self, space, method: str = "cadam", n_steps: int = 64, n_starts: int = 16,
                 n_mc: int = 32, lr: float = 0.05, inner_lr: float = 0.5, **kw):
        super().__init__(space, **kw)
        if method not in _METHODS:
            raise ValueError(f"unknown method {method!r}; known: {', '.join(_METHODS)}")
        self.method = method
        self.n_steps = n_steps
        self.n_starts = n_starts
        self.n_mc = n_mc
        self.lr = lr
        self.inner_lr = inner_lr

    def _draws(self, P: int, device, seed: int) -> CompDraws:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        k = 1 if self.method == "adam" else 2
        n = lambda *s: torch.randn(s, generator=gen, device=device)
        return CompDraws(init=n(self.n_mc, P), steps=n(self.n_steps, k, self.n_mc, P),
                         final=n(self.n_mc, P))

    def run(self, model, state, tau: float, X0: torch.Tensor, eps: CompDraws):
        """(X_final (P, D), scores (P,)): ``n_steps`` steps from X0."""
        lb = torch.as_tensor(self.space.opt_lb, dtype=torch.float32, device=X0.device)
        ub = torch.as_tensor(self.space.opt_ub, dtype=torch.float32, device=X0.device)
        lr, beta_in = self.lr, self.inner_lr

        def h(X, e):  # h(x, w) = τ − f_w(x): (S, P)
            return tau - _draw(model, state, X, e)

        def grad(fn, X, g_out=None):
            Xg = X.detach().requires_grad_(True)
            with torch.enable_grad():
                out = fn(Xg)
                return torch.autograd.grad(out, Xg, grad_outputs=g_out)[0]

        X = X0
        if self.method == "adam":  # plain MC gradient of −q-EI
            m, v = torch.zeros_like(X), torch.zeros_like(X)
            for i in range(self.n_steps):
                e = eps.steps[i, 0]
                g = grad(lambda Xg: -_outer_g(h(Xg, e)).sum(), X)
                X, m, v = adam_step(X, g, m, v, i + 1, lr)
                X = torch.minimum(torch.maximum(X, lb), ub)
        else:
            with torch.no_grad():
                y = h(X, eps.init).mean(0)
            m, v = torch.zeros_like(X), torch.zeros_like(X)
            for i in range(self.n_steps):
                # two-timescale tracking of the inner expectation
                beta = beta_in / math.sqrt(i + 1.0) if self.method == "scgd" else beta_in
                with torch.no_grad():
                    y = (1.0 - beta) * y + beta * h(X, eps.steps[i, 0]).mean(0)
                # chain rule: dL/dx = (dh/dx)ᵀ · dg/dy at y, with
                # L(y) = −Σ softplus(12y)/12
                gy = -torch.sigmoid(12.0 * y)
                e2 = eps.steps[i, 1]
                gx = grad(lambda Xg: h(Xg, e2).mean(0), X, gy)
                if self.method in ("cadam", "nasa"):
                    m = 0.9 * m + 0.1 * gx
                    v = 0.999 * v + 0.001 * gx ** 2
                    upd = lr * m / (torch.sqrt(v) + 1e-8)
                else:  # scgd / ascgd: (accelerated) SGD outer step
                    a = lr / math.sqrt(i + 1.0) * (2.0 if self.method == "ascgd" else 1.0)
                    upd = a * gx
                X = torch.minimum(torch.maximum(X - upd, lb), ub)
        with torch.no_grad():
            return X, -_outer_g(h(X, eps.final))

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0, eps: Optional[CompDraws] = None):
        tr = self._tr(tr_manager)
        X0 = torch.as_tensor(self._sample(tr, self.n_starts, seed).astype(np.float32),
                             device=model.device)
        if eps is None:
            eps = self._draws(X0.shape[0], model.device, seed)
        Xf, score = self.run(model, model.state, float(acq_params.tau), X0, eps)
        Xf = self.space.round_opt(Xf.cpu().numpy())
        return self._top_unique(Xf, score.cpu().numpy(), n_suggestions, x_observed)
