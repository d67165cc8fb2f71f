"""Deep-ensemble variants: MC batch-norm, Gumbel feature gates and
conditional inputs (port of ``hebo_tpu/models/nn/ensembles_ext.py``).

* ``MCBNEnsemble`` (``mcbn``): at prediction the standardized inputs are
  renormalized with the statistics of ``n_mc`` random training minibatches
  (host ``default_rng(0)`` draws, as in the JAX package); the passes run as
  one batched forward.
* ``GumbelDeepEnsemble`` (``gumbel``): per-member sigmoid input gates with
  Gumbel noise, trained jointly with the NLL; the per-epoch Gumbel draws can
  be fed as an (E, epochs, d) tensor.  It inherits ``predict_pure`` and
  ``sample_f``, which in the JAX package read ``params.w`` of its
  ``GumbelParams`` and raise ``AttributeError``; the port keeps both.
* ``ConditionalDeepEnsemble`` (``conditional_deep_ensemble``): an
  ``active_fn`` mask zeroes inactive columns and is appended as features
  (host numpy, a copy of the JAX package's).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..base import register_model
from .deep_ensemble import (DeepEnsemble, MLPParams, adam_fit, ensemble_moments, init_mlp,
                            member_loss, mlp_forward)

__all__ = ["MCBNEnsemble", "GumbelDeepEnsemble", "GumbelParams", "ConditionalDeepEnsemble"]


@register_model("mcbn")
class MCBNEnsemble(DeepEnsemble):
    """Monte-Carlo batch-norm: the input standardization re-estimated from
    random training minibatches, T passes giving the epistemic spread."""

    def __init__(self, space, num_out=1, **conf):
        conf.setdefault("num_ensembles", 3)
        super().__init__(space, num_out, **conf)
        self.n_mc = conf.get("n_mc", 8)
        self.bn_batch = conf.get("bn_batch", 8)
        self._train_F = None

    def fit(self, X, y, init: Optional[MLPParams] = None):
        super().fit(X, y, init=init)
        Fe = self._featurize(np.asarray(X, np.float64))
        mu_x, sd_x = self._x_stats
        self._train_F = (Fe - mu_x) / sd_x
        return self

    def predict(self, X):
        Fe = self._featurize(np.asarray(X, np.float64))
        (mu_x, sd_x), (mu_y, sd_y) = self._x_stats, self._y_stats
        Fs = (Fe - mu_x) / sd_x
        rng = np.random.default_rng(0)
        Ft = []
        for _ in range(self.n_mc):
            batch = self._train_F[rng.integers(0, len(self._train_F), self.bn_batch)]
            bmu, bsd = batch.mean(0), np.maximum(batch.std(0), 1e-3)
            Ft.append((Fs - bmu) / bsd)  # renormalize with minibatch statistics
        n = len(Fs)
        mus, vars_ = mlp_forward(self.params, self._f32(np.concatenate(Ft)))
        m, v = ensemble_moments(mus, vars_)
        mus = m.cpu().numpy().reshape(self.n_mc, n, 1)
        vars_ = v.cpu().numpy().reshape(self.n_mc, n, 1)
        mu = mus.mean(0)
        var = (vars_ + mus ** 2).mean(0) - mu ** 2
        return mu * sd_y + mu_y, np.maximum(var, 1e-8) * sd_y ** 2


class GumbelParams(NamedTuple):
    mlp: MLPParams
    gate_logits: torch.Tensor  # (E, D) feature-selection logits


def gumbel_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Standard Gumbel draws −log(−log U), U uniform on [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


@register_model("gumbel")
class GumbelDeepEnsemble(DeepEnsemble):
    """Per-member Gumbel-sigmoid input gates, trained jointly with the NLL."""

    def __init__(self, space, num_out=1, **conf):
        super().__init__(space, num_out, **conf)
        self.gate_temp = conf.get("gate_temp", 0.5)
        self.gate_l1 = conf.get("gate_l1", 1e-2)

    def fit(self, X, y, init: Optional[GumbelParams] = None,
            gumbels: Optional[torch.Tensor] = None):
        """``init`` feeds the initial params, ``gumbels`` the (E, epochs, d)
        gate noise of every step; otherwise both come from the model's
        generator (the gate logits start at 1)."""
        Fs, ys, w = self._prepare(X, y)
        E, d = self.num_ensembles, Fs.shape[1]
        gen = self._generator()
        if init is None:
            init = GumbelParams(mlp=init_mlp(E, self._sizes(d), gen, self.device),
                                gate_logits=torch.ones((E, d), device=self.device))
        if gumbels is None:
            gumbels = gumbel_noise((E, self.num_epochs, d), gen, self.device)
        gumbels = torch.as_tensor(gumbels, dtype=torch.float32, device=self.device)
        temp, gl1 = self.gate_temp, self.gate_l1

        def loss(p, step):
            gate = torch.sigmoid((p.gate_logits + gumbels[:, step]) / temp)
            mu, var = mlp_forward(p.mlp, Fs * gate[:, None, :])
            reg = gl1 * torch.sigmoid(p.gate_logits).sum(-1)
            return member_loss(mu, var, ys, w, "nll") + reg

        self.params = adam_fit(init, loss, self.num_epochs, self.lr)
        return self

    def _predict_scaled(self, Fs):
        gate = torch.sigmoid(self.params.gate_logits / self.gate_temp)
        return ensemble_moments(*mlp_forward(self.params.mlp, Fs * gate[:, None, :]))

    def feature_importance(self) -> np.ndarray:
        """Mean selection probability per input feature."""
        return torch.sigmoid(self.params.gate_logits / self.gate_temp).cpu().numpy().mean(axis=0)


@register_model("conditional_deep_ensemble")
class ConditionalDeepEnsemble(DeepEnsemble):
    """Conditional spaces: a validity mask per point zeroes the inactive
    dimensions and is appended as extra input features."""

    def __init__(self, space, num_out=1, active_fn=None, **conf):
        super().__init__(space, num_out, **conf)
        # active_fn(X_optframe) -> bool mask (n, num_cols); default: all on
        self.active_fn = active_fn

    def _featurize(self, X: np.ndarray) -> np.ndarray:
        F = super()._featurize(X)
        if self.active_fn is None:
            return F
        act = np.asarray(self.active_fn(X), float)  # (n, num_cols)
        # expand column mask to the one-hot feature frame
        space = self.space
        cols = list(space.numeric_dims + space.perm_dims)
        parts = [act[:, cols]]
        for c in space.cat_dims:
            ncat = int(space.num_categories[c])
            parts.append(np.repeat(act[:, c : c + 1], ncat, axis=1))
        m = np.concatenate(parts, axis=1)
        return np.concatenate([F * m, m], axis=1)
