"""Bayesian linear regression surrogate, BOCS's model (port of
``hebo_tpu/models/linreg.py``).

Order-2 polynomial features over the numerics and the one-hot categoricals
(one level dropped per column); estimators ``mle``, ``bayes`` (conjugate,
ridge 1) and ``horseshoe`` (Gibbs sampling, the default); Thompson sampling
draws one coefficient vector (the BOCS acquisition).

``_featurize`` and the ``mle`` and ``bayes`` estimators are host numpy, a
copy of the JAX package's, so they give the same numbers.  The horseshoe
chain (Makalic-Schmidt auxiliary variables, linreg.py:38-79) runs on the
model's device as ``n_gibbs`` sweeps with no host read inside the loop:
each sweep factors A = ΦᵀΦ + diag(1/(τ²λ²)) through kernel K1's jitter
ladder (``ops/chol.batched_ladder_factor``, the JAX package's
``safe_cholesky``) and takes the mean Wᵀ(W Φᵀy) and the draw Wᵀz from
W = L⁻¹.  The chain's random numbers are drawn before the loop in one call
per kind (the shapes of the inverse-gamma draws are constant over the
chain), or fed (``GibbsDraws``) so that a test can replay the JAX
package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.chol import LADDER, batched_ladder_factor
from ..utils.device import resolve_device
from .base import BaseModel, register_model

__all__ = ["LinRegModel", "GibbsDraws", "draw_gibbs", "horseshoe_sweep", "horseshoe_gibbs"]


class GibbsDraws(NamedTuple):
    """The chain's random numbers, one row per sweep: standard normals z
    (T, p) and standard-gamma draws for λ² (T, p), ν (T, p), τ² (T,),
    ξ (T,) and σ² (T,) at shapes 1, 1, (p + 1)/2, 1 and (n + p)/2."""

    z: torch.Tensor
    lam: torch.Tensor
    nu: torch.Tensor
    tau: torch.Tensor
    xi: torch.Tensor
    sig: torch.Tensor


def draw_gibbs(n_gibbs: int, n: int, p: int, generator: Optional[torch.Generator],
               device) -> GibbsDraws:
    """All ``n_gibbs`` sweeps' draws at once, on ``device``."""
    f32 = dict(dtype=torch.float32, device=device)
    gamma = lambda shape, size: torch._standard_gamma(torch.full(size, shape, **f32),
                                                      generator=generator)
    T = (n_gibbs,)
    return GibbsDraws(
        z=torch.randn((n_gibbs, p), generator=generator, **f32),
        lam=gamma(1.0, (n_gibbs, p)), nu=gamma(1.0, (n_gibbs, p)),
        tau=gamma(0.5 * (p + 1.0), T), xi=gamma(1.0, T), sig=gamma(0.5 * (n + p), T),
    )


def _inv_gamma(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """InvGamma(shape, scale) from a standard-gamma draw g at that shape."""
    return scale / torch.clamp(g, min=1e-12)


def horseshoe_sweep(carry, PtP, Pty, Phi, y, d):
    """One Gibbs sweep.  ``carry`` = (w (p,), λ² (p,), τ², ν (p,), ξ, σ²),
    the scalars 0-d; ``d`` the sweep's draws (z, g_λ, g_ν, g_τ, g_ξ, g_σ);
    y (n,).  Returns the next carry."""
    w, lam2, tau2, nu, xi, sig2 = carry
    z, g_lam, g_nu, g_tau, g_xi, g_sig = d
    A = PtP + torch.diag(1.0 / torch.clamp(tau2 * lam2, min=1e-10))
    _, W, _ = batched_ladder_factor(A[None], LADDER)
    W = W[0]
    Wt = W.transpose(0, 1)
    w = Wt @ (W @ Pty) + torch.sqrt(sig2) * (Wt @ z)
    lam2 = _inv_gamma(g_lam, 1.0 / nu + w ** 2 / (2.0 * tau2 * sig2))
    nu = _inv_gamma(g_nu, 1.0 + 1.0 / lam2)
    tau2 = _inv_gamma(g_tau, 1.0 / xi + (w ** 2 / lam2).sum() / (2.0 * sig2))
    xi = _inv_gamma(g_xi, 1.0 + 1.0 / tau2)
    resid = y - Phi @ w
    sig2 = _inv_gamma(g_sig, 0.5 * (resid ** 2).sum() + 0.5 * (w ** 2 / (tau2 * lam2)).sum())
    sig2 = torch.clamp(sig2, 1e-8, 1e6)
    return w, lam2, tau2, nu, xi, sig2


def _init_carry(p: int, device):
    one = torch.ones((), dtype=torch.float32, device=device)
    vec = lambda v: torch.full((p,), v, dtype=torch.float32, device=device)
    return vec(0.0), vec(1.0), one, vec(1.0), one.clone(), one.clone()


def horseshoe_gibbs(Phi: torch.Tensor, y: torch.Tensor, n_gibbs: int = 300,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[GibbsDraws] = None) -> torch.Tensor:
    """The chain from w = 0, λ² = τ² = ν = ξ = σ² = 1 over Φ (n, p), y (n, 1):
    the coefficient draws (n_gibbs − n_gibbs // 2, p) of its second half."""
    n, p = Phi.shape
    yv = y.reshape(n)
    PtP = Phi.transpose(0, 1) @ Phi
    Pty = Phi.transpose(0, 1) @ yv
    d = draw_gibbs(n_gibbs, n, p, generator, Phi.device) if draws is None else draws
    carry = _init_carry(p, Phi.device)
    out = Phi.new_empty((n_gibbs - n_gibbs // 2, p))
    for t in range(n_gibbs):
        carry = horseshoe_sweep(carry, PtP, Pty, Phi, yv, [x[t] for x in d])
        if t >= n_gibbs // 2:
            out[t - n_gibbs // 2] = carry[0]
    return out


@register_model("lin_reg")
class LinRegModel(BaseModel):
    support_ts = True

    def __init__(self, space, num_out=1, device="cuda", **conf):
        super().__init__(space, num_out, **conf)
        if num_out != 1:
            raise ValueError("LinRegModel is single-output")
        self.device = resolve_device(device)
        self.order = conf.get("order", 2)
        self.estimator = conf.get("estimator", "horseshoe")  # mle | bayes | horseshoe
        self.n_gibbs = conf.get("n_gibbs", 300)
        self._seed = conf.get("seed", 0)
        self.w_draws = None
        self.w_mean = None
        self._y_stats = (0.0, 1.0)
        self._resid_var = 0.0
        self._state = None
        self._index = {}

    # ------------------------------------------------------------- features
    def _featurize(self, X: np.ndarray) -> np.ndarray:
        """One-hot cats + numerics, then order-2 interaction features."""
        space = self.space
        base = [np.asarray(X, float)[:, space.numeric_dims + space.perm_dims]]
        for c in space.cat_dims:
            n = int(space.num_categories[c])
            oh = np.zeros((len(X), n))
            oh[np.arange(len(X)), np.asarray(X)[:, c].astype(int)] = 1.0
            base.append(oh[:, 1:])  # drop one level (identifiability)
        Z = np.concatenate(base, axis=1)
        feats = [np.ones((len(Z), 1)), Z]
        if self.order >= 2:
            d = Z.shape[1]
            iu = np.triu_indices(d, k=1)
            feats.append(Z[:, iu[0]] * Z[:, iu[1]])
        return np.concatenate(feats, axis=1)

    def _columns(self, device):
        """Index tensors of ``_featurize_t`` on ``device``, made once."""
        key = str(device)
        cols = self._index.get(key)
        if cols is None:
            space = self.space
            ncat = [int(space.num_categories[c]) for c in space.cat_dims]
            offs = np.cumsum([0] + ncat[:-1]).astype(np.int64)
            keep = [o + j for o, n in zip(offs, ncat) for j in range(1, n)]
            d = len(space.numeric_dims) + len(space.perm_dims) + len(keep)
            iu = np.triu_indices(d, k=1)
            t = lambda v: torch.as_tensor(np.asarray(v, np.int64), device=device)
            cols = (t(space.numeric_dims + space.perm_dims), t(space.cat_dims), t(offs), t(keep),
                    sum(ncat), t(iu[0]), t(iu[1]))
            self._index[key] = cols
        return cols

    def _featurize_t(self, X: torch.Tensor) -> torch.Tensor:
        """``_featurize`` of opt-frame rows X (P, D) on their device."""
        num_idx, cat_idx, offs, keep, total, iu0, iu1 = self._columns(X.device)
        parts = [X.index_select(1, num_idx)]
        if len(self.space.cat_dims):
            codes = X.index_select(1, cat_idx).long() + offs[None, :]
            oh = X.new_zeros((X.shape[0], total)).scatter_(1, codes, 1.0)
            parts.append(oh.index_select(1, keep))
        Z = torch.cat(parts, 1)
        feats = [X.new_ones((X.shape[0], 1)), Z]
        if self.order >= 2:
            feats.append(Z.index_select(1, iu0) * Z.index_select(1, iu1))
        return torch.cat(feats, 1)

    def fit(self, X, y):
        y = np.asarray(y, float).reshape(len(X), 1)
        ok = np.isfinite(y[:, 0])
        Phi = self._featurize(np.asarray(X)[ok])
        yv = y[ok]
        mu_y, sd_y = float(yv.mean()), max(float(yv.std()), 1e-8)
        self._y_stats = (mu_y, sd_y)
        ys = (yv - mu_y) / sd_y
        n, p = Phi.shape
        if self.estimator == "mle":
            w, *_ = np.linalg.lstsq(Phi, ys[:, 0], rcond=None)
            self.w_mean = w
            self.w_draws = w[None, :]
            self._resid_var = float(np.mean((Phi @ w - ys[:, 0]) ** 2)) + 1e-6
        elif self.estimator == "bayes":
            lam = 1.0
            A = Phi.T @ Phi + lam * np.eye(p)
            w = np.linalg.solve(A, Phi.T @ ys[:, 0])
            resid = ys[:, 0] - Phi @ w
            sig2 = float(np.sum(resid ** 2) / max(n - 1, 1)) + 1e-6
            cov = sig2 * np.linalg.inv(A)
            rng = np.random.default_rng(self._seed)
            self.w_mean = w
            self.w_draws = rng.multivariate_normal(w, cov, size=32)
            self._resid_var = sig2
        else:  # horseshoe
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self._seed)
            f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            draws = horseshoe_gibbs(f32(Phi), f32(ys), n_gibbs=self.n_gibbs, generator=gen)
            self.w_draws = draws.cpu().numpy()
            self.w_mean = self.w_draws.mean(axis=0)
            self._resid_var = float(np.mean((Phi @ self.w_mean - ys[:, 0]) ** 2)) + 1e-6
        self._seed += 1
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=self.device)
        self._state = (f32(self.w_draws), f32(self._resid_var), f32(mu_y), f32(sd_y))
        return self

    def predict(self, X):
        Phi = self._featurize(X)
        mu_y, sd_y = self._y_stats
        preds = Phi @ self.w_draws.T  # (n, S)
        mu = preds.mean(axis=1, keepdims=True)
        var = preds.var(axis=1, keepdims=True) + self._resid_var
        return mu * sd_y + mu_y, var * sd_y ** 2

    # ------------------------------------------------- pure-state protocol
    @property
    def state(self):
        """(w_draws (S, p), residual variance, y mean, y std) on the device."""
        if self._state is None:
            raise RuntimeError("fit first")
        return self._state

    def predict_pure(self, state, Xs: torch.Tensor):
        w_draws, resid_var, mu_y, sd_y = state
        preds = self._featurize_t(Xs) @ w_draws.transpose(0, 1)  # (n, S)
        mu = preds.mean(1, keepdim=True)
        var = preds.var(1, unbiased=False, keepdim=True) + resid_var
        return mu * sd_y + mu_y, var * sd_y ** 2

    def joint_sample_pure(self, state, generator: torch.Generator, Xs: torch.Tensor):
        """Thompson sample (the BOCS acquisition): one coefficient vector
        picked uniformly with ``generator``, evaluated as Φ(Xs)·w → (P, 1),
        with no host read."""
        w_draws, resid_var, mu_y, sd_y = state
        i = torch.randint(0, w_draws.shape[0], (1,), generator=generator, device=Xs.device)
        f = self._featurize_t(Xs) @ w_draws.index_select(0, i)[0]
        return f[:, None] * sd_y + mu_y

    def sample_f(self, n_samples: int = 1, seed: int = 0):
        """Thompson sampling: one coefficient draw per sample (BOCS)."""
        idx = [(seed + i) % len(self.w_draws) for i in range(n_samples)]
        W = self.w_draws[idx]
        mu_y, sd_y = self._y_stats

        def f(Xq):
            Phi = self._featurize(np.asarray(Xq))
            return (Phi @ W.T).T[:, :, None] * sd_y + mu_y

        return f

    @property
    def noise(self):
        return np.asarray([self._resid_var * self._y_stats[1] ** 2])
