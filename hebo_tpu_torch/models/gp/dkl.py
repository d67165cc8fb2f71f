"""Deep-kernel GP: a learned MLP feature map ahead of the kernel (port of
``hebo_tpu/models/gp/dkl.py``; SVIDKL, NAP's ``DeepKernelGP``).

The scaled inputs (the numerics in [−1, 1], each categorical code as one
normalised input) pass through tanh(h W1 + b1) W2 + b2 into ``feat_dim``
(8) features; the weights are packed in ``params.emb`` (B, n_weights, 1)
and fitted with the other hyperparameters on the marginal likelihood
(Adam, 150 epochs, lr 0.01).  The ARD Matérn-3/2 Gram over the features is
kernel K2 on CUDA, and its VJP carries the gradient back through the MLP.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..base import register_model
from .gp import GP, GPCore, GPData, GPParams

__all__ = ["DKLCore", "DKLGP"]


class DKLCore(GPCore):
    """GPCore whose feature map is scaled inputs → 2-layer MLP."""

    def __init__(self, *args, feat_dim: int = 8, feat_hidden: int = 32, **kw):
        super().__init__(*args, **kw)
        self.feat_dim = feat_dim
        self.feat_hidden = feat_hidden
        d_in = self.d_num + len(self.cat_dims)
        self._shapes = [(d_in, feat_hidden), (feat_hidden,), (feat_hidden, feat_dim), (feat_dim,)]
        self._n_w = sum(int(np.prod(s)) for s in self._shapes)
        # ARD over the learned features
        self.n_feat_dims = feat_dim
        self.n_cat_param = 0
        self.d_feat = feat_dim

    def _unpack(self, flat: torch.Tensor):
        """(B, n_weights) → [w1 (B, d_in, H), b1 (B, 1, H), w2, b2]."""
        ws, o = [], 0
        for s in self._shapes:
            n = int(np.prod(s))
            ws.append(flat[:, o : o + n].reshape((flat.shape[0],) + ((1,) + s if len(s) == 1 else s)))
            o += n
        return ws

    def features(self, params: GPParams, X: torch.Tensor, data: GPData) -> torch.Tensor:
        num_idx, cat_idx, _ = self._columns(X.device)
        parts = []
        if self.d_num:
            u = torch.clamp((X.index_select(1, num_idx) - data.x_lb) / data.x_span, 0.0, 1.0)
            parts.append(2.0 * u - 1.0)
        if self.cat_dims:  # normalised codes as extra inputs
            ncat = self._const("dkl_ncat", X.device, lambda d: torch.as_tensor(
                [max(float(n) - 1.0, 1.0) for n in self.num_categories], device=d))
            parts.append(X.index_select(1, cat_idx) / ncat * 2.0 - 1.0)
        h = torch.cat(parts, -1)
        w1, b1, w2, b2 = self._unpack(params.emb[:, :, 0])
        h = torch.tanh(h @ w1 + b1)
        return h @ w2 + b2

    def init_params(self, data: GPData, n: int, generator: Optional[torch.Generator] = None,
                    draws=None) -> GPParams:
        """``n`` stacked sets (dkl.py:79-95): weights 0.3·N(0, 1),
        lengthscales 0.1·N(0, 1).  ``draws`` = (weight normals
        (n, n_weights, 1), ls normals (n, feat_dim))."""
        f32 = dict(dtype=torch.float32, device=data.X.device)
        if draws is None:
            z_w = torch.randn((n, self._n_w, 1), generator=generator, **f32)
            z_ls = torch.randn((n, self.feat_dim), generator=generator, **f32)
        else:
            z_w, z_ls = (torch.as_tensor(t, **f32) for t in draws)
        return GPParams(
            log_ls=0.1 * z_ls, log_sc=torch.zeros((n,), **f32),
            log_noise=torch.full((n,), math.log(1e-2), **f32), mean=torch.zeros((n,), **f32),
            emb=0.3 * z_w, log_wa=torch.zeros((n, self.d_num), **f32),
            log_wb=torch.zeros((n, self.d_num), **f32))


@register_model("dkl")
class DKLGP(GP):
    def __init__(self, space, num_out: int = 1, device="cuda", **conf):
        super().__init__(space, num_out=num_out, device=device, **conf)
        self.core = DKLCore(
            numeric_dims=tuple(space.numeric_dims) + tuple(space.perm_dims),
            cat_dims=tuple(space.cat_dims),
            num_categories=tuple(int(space.num_categories[c]) for c in space.cat_dims),
            kernel=conf.get("kernel", "matern32"),
            optimizer=conf.get("optimizer", "adam"),
            n_steps=conf.get("num_epochs", 150),
            lr=conf.get("lr", 0.01),
            n_ensemble=conf.get("n_ensemble", 1),
            feat_dim=conf.get("feat_dim", 8),
            feat_hidden=conf.get("feat_hidden", 32),
        )
