"""Latent-space BO with weighted VAE retraining (the T-LBO loop; port of
``hebo_tpu/latent/lbo.py``).

Rank-weighted data reweighting → periodic VAE finetuning (with the metric
loss) → GP + EI in the latent box (``EvolutionOpt``, pop 48 for 32
generations) → decode → dedupe against the history → evaluate.  The VAE
retrains on its padded bucket (zero-weight rows, a labeled mask) with the
reparameterisation normals from the optimizer's generator; the GP and the
acquisition run on ``device``.  Walls per phase: ``retrain_time``,
``fit_time``, ``acq_time``, ``decode_time``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
import torch
from torch.func import functional_call

from ..acq_optimizers.evolution import EvolutionOpt
from ..acquisitions.acq import EI, AcqParams
from ..design_space import DesignSpace
from ..models import get_model
from ..optimizers.base import AbstractOptimizer, timed
from ..utils.device import resolve_device
from ..utils.dtypes import pad_bucket
from .vae import VAE, init_params, rank_weights, sub_params, train_vae

__all__ = ["LatentSpaceBO"]


class LatentSpaceBO(AbstractOptimizer):
    """Ask/tell optimizer over a structured space via a learned latent box."""

    def __init__(
        self,
        space: DesignSpace,
        latent_dim: int = 4,
        latent_bound: float = 3.0,
        retrain_every: int = 8,
        n_init: Optional[int] = None,
        rank_k: float = 1e-3,
        vae_hidden: int = 64,
        vae_steps: int = 200,
        model_config: Optional[dict] = None,
        seed: int = 0,
        csv_save_path: Optional[str] = None,
        unlabeled_weight: float = 0.5,
        device="cuda",
    ):
        super().__init__(space, csv_save_path)
        self.device = resolve_device(device)
        self.unlabeled_weight = unlabeled_weight
        self._unlabeled: Optional[np.ndarray] = None  # opt-frame rows
        self.latent_dim = latent_dim
        self.retrain_every = retrain_every
        self.n_init = n_init if n_init is not None else 2 * latent_dim + 2
        self.rank_k = rank_k
        self.vae_steps = vae_steps
        self.model_config = model_config or {"num_epochs": 30}
        self._sobol_count = 0

        cat_dims = tuple(int(space.num_categories[c]) for c in space.cat_dims)
        self._all_cat = len(space.cat_dims) == space.num_cols and space.num_cols > 0
        self.vae = VAE(
            latent_dim=latent_dim,
            out_dim=space.num_cols,
            hidden=vae_hidden,
            categorical_dims=cat_dims if self._all_cat else (),
            seed=seed,
            device=self.device,
        )
        self.vae_params = init_params(self.vae)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.latent_space = DesignSpace(
            [
                {"name": f"z{i}", "type": "num", "lb": -latent_bound, "ub": latent_bound}
                for i in range(latent_dim)
            ]
        )
        self.gp = None
        self._evo = None
        self._n_retrains = 0
        self.retrain_time: list = []
        self.decode_time: list = []

    # ----------------------------------------------------------- vae utils
    def _normalize(self, X: np.ndarray) -> np.ndarray:
        if self._all_cat:
            return X.astype(np.float32)
        lb, ub = self.space.opt_lb, self.space.opt_ub
        return ((X - lb) / np.maximum(ub - lb, 1e-9)).astype(np.float32) * 2 - 1

    def _denormalize(self, Xn: np.ndarray) -> np.ndarray:
        if self._all_cat:
            return Xn
        lb, ub = self.space.opt_lb, self.space.opt_ub
        return lb + (np.clip(Xn, -1, 1) + 1) / 2 * (ub - lb)

    def _encode(self, X: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            x = torch.as_tensor(self._normalize(X), device=self.device)
            mu, _ = functional_call(self.vae.encoder, sub_params(self.vae_params, "encoder"), (x,))
        return mu.cpu().numpy()

    def _decode(self, Z: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            z = torch.as_tensor(np.asarray(Z, np.float32), device=self.device)
            out = functional_call(self.vae.decoder, sub_params(self.vae_params, "decoder"), (z,))
            if self._all_cat:
                return torch.stack([torch.argmax(lg, -1) for lg in out], 1).cpu().numpy().astype(float)
            out = out.cpu().numpy()
        return self.space.round_opt(self._denormalize(out))

    def add_unlabeled(self, df: pd.DataFrame) -> None:
        """Register unlabeled structures for semi-supervised retraining.

        T-LBO semi-supervised mode: the VAE finetune sees these rows with a
        fixed ``unlabeled_weight`` reconstruction weight; the rank
        reweighting and the metric loss remain labeled-only.
        """
        Xu = self.space.transform(df)
        self._unlabeled = Xu if self._unlabeled is None else np.vstack([self._unlabeled, Xu])

    def _retrain(self):
        X = self.space.transform(self.X)
        y = self.y[:, :1]
        ok = np.isfinite(y[:, 0])
        Xv, yv = X[ok], y[ok]
        w = rank_weights(yv[:, 0], self.rank_k)
        n_lab = len(Xv)
        if self._unlabeled is not None and len(self._unlabeled):
            Xv = np.vstack([Xv, self._unlabeled])
            yv = np.vstack([yv, np.zeros((len(self._unlabeled), 1), yv.dtype)])
            w = np.concatenate([w, np.full((len(self._unlabeled),), self.unlabeled_weight)])
        # pad to the bucket with zero-weight rows, as the JAX package does
        # (its one compile per bucket)
        n = len(Xv)
        n_pad = pad_bucket(max(n, 2))
        Xn = self._normalize(Xv)
        Xp = np.zeros((n_pad, Xn.shape[1]), np.float32)
        yp = np.zeros((n_pad, 1), np.float32)
        wp = np.zeros((n_pad,), np.float32)
        lp = np.zeros((n_pad,), bool)
        Xp[:n], yp[:n], wp[:n] = Xn, yv, w
        lp[:n_lab] = True
        self.vae_params, _ = train_vae(self.vae, self.vae_params, Xp, yp, wp,
                                       n_steps=self.vae_steps, labeled=lp, generator=self._gen)
        self._n_retrains += 1

    def _pick(self, pop_Z: np.ndarray, pop_F: np.ndarray, X: np.ndarray, n: int) -> np.ndarray:
        """Decode the population best-first in one call and keep the first
        ``n`` rows new to the history and to each other; Sobol points fill
        any shortfall."""
        Xc = self._decode(pop_Z[np.argsort(pop_F[:, 0])])
        hist = {tuple(np.round(r, 6)) for r in X}
        picks, seen = [], set()
        for row in Xc:
            kk = tuple(np.round(row, 6))
            if kk in hist or kk in seen:
                continue
            seen.add(kk)
            picks.append(row)
            if len(picks) == n:
                break
        while len(picks) < n:
            picks.append(self.space.sobol_sample_opt(1, seed=self.num_obs + len(picks))[0])
        return np.stack(picks)

    # -------------------------------------------------------------- ask/tell
    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.num_obs < self.n_init:
            X = self.space.sobol_sample_opt(n_suggestions, seed=self._sobol_count)
            self._sobol_count += 1
            return self.space.inverse_transform(X)

        if self._n_retrains == 0 or self.num_obs % self.retrain_every == 0:
            with timed(self.retrain_time, self.device):
                self._retrain()

        X = self.space.transform(self.X)
        y = self.y[:, :1]
        ok = np.isfinite(y[:, 0])
        with timed(self.fit_time, self.device):
            Z = self._encode(X[ok])
            ys = (y[ok] - y[ok].mean()) / max(y[ok].std(), 1e-12)
            if self.gp is None:
                self.gp = get_model("gp", self.latent_space, num_out=1, device=self.device,
                                    **self.model_config)
            self.gp.fit(Z, ys)
        with timed(self.acq_time, self.device):
            if self._evo is None:
                self._evo = EvolutionOpt(self.latent_space, EI(), pop=48, iters=32)
            pop_Z, pop_F = self._evo.optimize(
                model=self.gp,
                acq_params=AcqParams(tau=float(np.min(ys))),
                initial_suggest=Z[np.argmin(ys[:, 0])][None, :],
                return_pop=True,
                seed=self.num_obs,
            )
        with timed(self.decode_time, self.device):
            picks = self._pick(pop_Z, pop_F, X, n_suggestions)
        return self.space.inverse_transform(picks)
