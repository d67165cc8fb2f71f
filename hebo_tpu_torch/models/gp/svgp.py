"""Sparse GP surrogate, the collapsed variational (Titsias) bound (port of
``hebo_tpu/models/gp/svgp.py``).

M inducing locations Z in feature space (the scaled numerics and the
categorical embeddings) and the kernel hyperparameters are fitted jointly
by Adam on the negative ELBO, with gradients clipped to ±1e3
(svgp.py:120-151).  Every factorization goes through the jitter ladder
(kernel K1 on CUDA) as a differentiable function
(``ops/chol.ladder_factor_inv``) whose backward uses W = L⁻¹ products, and
every triangular solve of the JAX package (svgp.py:52-57, :81-85, :94-95)
is a product with W.  The Gram over feature points is ``GPCore.gram``
(kernel K2 with its VJP for Matérn-3/2 on CUDA), so the gradient reaches Z
and the lengthscales through K2's VJP.

Parameters keep the port's leading batch axis (here 1): ``SVGPParams(gp,
Z (1, M, F))``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...ops.chol import LADDER, ladder_factor_inv
from ...utils.dtypes import pad_bucket
from ..base import register_model
from .gp import GP, GPCore, GPData, GPParams, make_data
from .tree import adam_step, tree_leaves, tree_unflatten

__all__ = ["SVGP", "SVGPCore", "SVGPParams", "SVGPCache"]


class SVGPParams(NamedTuple):
    gp: GPParams
    Z: torch.Tensor  # (B, M, F) inducing locations in feature space


class SVGPCache(NamedTuple):
    """Factors of Kmm and A = Kmm + Kmn Knm / σ² with their inverses, and
    w = A⁻¹ Kmn r / σ²."""

    Lm: torch.Tensor
    Wm: torch.Tensor
    La: torch.Tensor
    Wa: torch.Tensor
    w: torch.Tensor  # (B, M, 1)


class SVGPCore(GPCore):
    def __init__(self, *args, num_inducing: int = 32, **kw):
        super().__init__(*args, **kw)
        self.num_inducing = num_inducing

    def _inducing(self, p: SVGPParams, data: GPData):
        """(f, m, noise, Kmm + 1e-5 I, Kmn masked)."""
        gp = p.gp
        f = self.features(gp, data.X, data)
        m = data.mask.to(f.dtype)
        noise = torch.exp(gp.log_noise) + self.noise_lb
        M = p.Z.shape[1]
        Kmm = self.gram(gp, p.Z, p.Z) + 1e-5 * torch.eye(M, dtype=f.dtype, device=f.device)
        Kmn = self.gram(gp, p.Z, f) * m
        return f, m, noise, Kmm, Kmn

    def neg_elbo(self, p: SVGPParams, data: GPData) -> torch.Tensor:
        """(B,) the negative collapsed ELBO (svgp.py:41-69)."""
        gp = p.gp
        f, m, noise, Kmm, Kmn = self._inducing(p, data)
        M = Kmm.shape[-1]
        _, Wm, _ = ladder_factor_inv(Kmm, LADDER)
        A = Wm @ Kmn  # (B, M, N)
        nb = noise[:, None, None]
        Bm = torch.eye(M, dtype=f.dtype, device=f.device) + (A @ A.transpose(-1, -2)) / nb
        Lb, Wb, _ = ladder_factor_inv(Bm, LADDER)
        r = (data.y - gp.mean[:, None, None]) * m[:, None]
        c = (Wb @ (A @ r)) / nb
        n_act = m.sum()
        # log|Qnn + σ²I| = log|B| + n log σ²
        logdet = 2.0 * torch.log(torch.diagonal(Lb, dim1=-2, dim2=-1)).sum(-1) + n_act * torch.log(noise)
        quad = (r * r).sum((-2, -1)) / noise - (c * c).sum((-2, -1)) / noise
        # trace correction: Σ_i k(x_i, x_i) − q(x_i, x_i), masked
        kss = torch.exp(gp.log_sc) * n_act
        qnn = ((A * A) * m).sum((-2, -1))
        trace = (kss - qnn) / noise
        elbo = -0.5 * (quad + logdet + n_act * math.log(2 * math.pi)) - 0.5 * trace
        return -elbo

    def loss(self, p: SVGPParams, data: GPData) -> torch.Tensor:
        return self.neg_elbo(p, data) - self.log_prior(p.gp)

    @torch.no_grad()
    def svgp_cache(self, p: SVGPParams, data: GPData) -> SVGPCache:
        """(svgp.py:72-87)."""
        gp = p.gp
        f, m, noise, Kmm, Kmn = self._inducing(p, data)
        Lm, Wm, _ = ladder_factor_inv(Kmm, LADDER)
        Amat = Kmm + (Kmn @ Kmn.transpose(-1, -2)) / noise[:, None, None]
        La, Wa, _ = ladder_factor_inv(Amat, LADDER)
        r = (data.y - gp.mean[:, None, None]) * m[:, None]
        w = Wa.transpose(-1, -2) @ (Wa @ (Kmn @ r)) / noise[:, None, None]
        return SVGPCache(Lm=Lm, Wm=Wm, La=La, Wa=Wa, w=w)

    def svgp_predict(self, p: SVGPParams, cache: SVGPCache, data: GPData, Xs: torch.Tensor):
        """(mu, var), each (B, P, 1), standardized-y frame (svgp.py:89-99)."""
        gp = p.gp
        fs = self.features(gp, Xs, data)
        Ks = self.gram(gp, p.Z, fs)  # (B, M, P)
        mu = gp.mean[:, None, None] + Ks.transpose(-1, -2) @ cache.w
        v1 = cache.Wm @ Ks
        v2 = cache.Wa @ Ks
        var = torch.exp(gp.log_sc)[:, None] - (v1 * v1).sum(-2) + (v2 * v2).sum(-2)
        return mu, torch.clamp(var, min=1e-10)[..., None]


@register_model("svgp")
class SVGP(GP):
    """Host wrapper (svgp.py:102-205): the exact GP's buckets, an Adam fit
    of (hyperparameters, Z) for ``num_epochs`` (150) steps at ``lr`` 0.03."""

    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        super().__init__(space, num_out=num_out, device=device, **conf)
        self.core = SVGPCore(
            numeric_dims=tuple(space.numeric_dims) + tuple(space.perm_dims),
            cat_dims=tuple(space.cat_dims),
            num_categories=tuple(int(space.num_categories[c]) for c in space.cat_dims),
            kernel=conf.get("kernel", "matern32"),
            optimizer="adam",
            n_steps=conf.get("num_epochs", 150),
            lr=conf.get("lr", 0.03),
            num_inducing=conf.get("num_inducing", 32),
        )
        self._cache: Optional[SVGPCache] = None

    def init_params(self, data: GPData, generator: Optional[torch.Generator] = None,
                    draws=None) -> SVGPParams:
        """The GP's init and Z at random (padded) rows' features plus 0.01·N(0, 1)
        (svgp.py:121-131).  ``draws`` = (init_params' draws, idx (M,),
        normals (M, F)) replaces the generator's."""
        core = self.core
        gp0 = core.init_params(data, 1, generator, draws=None if draws is None else draws[0])
        f = core.features(gp0, data.X, data)[0]
        M = core.num_inducing
        if draws is None:
            idx = torch.randint(0, data.X.shape[0], (M,), generator=generator, device=f.device)
            z = torch.randn((M, f.shape[1]), generator=generator, device=f.device)
        else:
            idx, z = (torch.as_tensor(t, device=f.device) for t in draws[1:])
        return SVGPParams(gp=gp0, Z=(f.index_select(0, idx.long()) + 0.01 * z)[None])

    def fit_params(self, p0: SVGPParams, data: GPData) -> SVGPParams:
        """Adam on (hyperparameters, Z), gradients clipped to ±1e3."""
        core = self.core
        p = [t.detach().clone() for t in tree_leaves(p0)]
        mu = [torch.zeros_like(t) for t in p]
        nu = [torch.zeros_like(t) for t in p]
        for i in range(core.n_steps):
            leaves = [t.requires_grad_(True) for t in p]
            with torch.enable_grad():
                total = core.loss(tree_unflatten(p0, leaves), data).sum()
                gs = torch.autograd.grad(total, leaves, allow_unused=True)
            with torch.no_grad():
                for j, (t, g) in enumerate(zip(p, gs)):
                    g = torch.zeros_like(t) if g is None else torch.clamp(g, -1e3, 1e3)
                    p[j], mu[j], nu[j] = adam_step(t.detach(), g, mu[j], nu[j], i + 1, core.lr)
        return tree_unflatten(p0, [t.detach() for t in p])

    def fit(self, X, y):
        self.data = make_data(X, y, self.core.numeric_dims, pad_bucket(max(len(X), 2)), self.device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self._seed)
        self._seed += 1
        self.params = self.fit_params(self.init_params(self.data, gen), self.data)
        self._cache = self.core.svgp_cache(self.params, self.data)
        return self

    @torch.no_grad()
    def predict(self, X):
        if self.data is None:
            raise RuntimeError("fit first")
        X = np.asarray(X, dtype=np.float32)
        p = len(X)
        Xp = np.zeros((pad_bucket(p), X.shape[1]), np.float32)
        Xp[:p] = X
        mu, var = self.predict_pure(self.state, torch.as_tensor(Xp, device=self.device))
        return mu.cpu().numpy()[:p], var.cpu().numpy()[:p]

    @property
    def state(self):
        return (self.params, self._cache, self.data)

    def predict_pure(self, state, Xs: torch.Tensor):
        params, cache, data = state
        mu, var = self.core.svgp_predict(params, cache, data, Xs)
        return mu[0] * data.y_std + data.y_mean, var[0] * data.y_std ** 2

    @property
    def noise(self):
        ys = float(self.data.y_std)
        return np.asarray([float(torch.exp(self.params.gp.log_noise[0]) + self.core.noise_lb) * ys ** 2])
