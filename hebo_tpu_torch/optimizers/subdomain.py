"""Subdomain BO: BO restricted to 1-D lines or a trust-region box through
the incumbent (port of ``hebo_tpu/optimizers/subdomain.py``, febo's
LineBO family):

* ``CoordinateLineBO`` — lines along the coordinate axes, in turn;
* ``RandomLineBO``     — lines in uniformly random directions;
* ``AscentLineBO``     — the line along the GP posterior mean's descent
                         direction at the incumbent (``torch.autograd``
                         through the posterior; K2's VJP on CUDA);
* ``mode="tr"``        — a box of ``tr_radius`` × the span around the
                         incumbent.

Each suggest fits the GP on all the data and minimizes LCB inside the
subdomain: a candidate grid (one batched evaluation on the model's
device), then multi-start L-BFGS from the grid's best (``solvers``).  A
line phase ends after ``line_steps`` suggestions, or early when the LCB of
the line's best grid point is above the incumbent's value.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..acquisitions.acq import LCB, AcqParams
from ..acq_optimizers.solvers import grid_solver, multi_start_lbfgs
from ..models import get_model
from ..utils.device import resolve_device
from .base import AbstractOptimizer, timed

__all__ = ["SubDomainBO", "CoordinateLineBO", "RandomLineBO", "AscentLineBO"]


class SubDomainBO(AbstractOptimizer):
    support_parallel_opt = False

    def __init__(
        self,
        space,
        mode: str = "coordinate",  # coordinate | random | ascent | tr
        n_init: Optional[int] = None,
        line_steps: int = 5,
        tr_radius: float = 0.2,
        kappa: float = 2.0,
        model_config: Optional[dict] = None,
        csv_save_path: Optional[str] = None,
        seed: int = 0,
        device="cuda",
    ):
        super().__init__(space, csv_save_path)
        if space.cat_dims:
            raise ValueError("subdomain BO is continuous-only (febo)")
        self.device = resolve_device(device)
        self.mode = mode
        self.n_init = n_init if n_init is not None else 1 + space.num_cols
        self.line_steps = line_steps
        self.tr_radius = tr_radius
        self.kappa = kappa
        self.model_config = {"num_epochs": 30, "n_restarts": 1, **(model_config or {})}
        self.rng = np.random.default_rng(seed)
        self._sobol_count = 0
        self._phase_left = 0
        self._direction: Optional[np.ndarray] = None
        self._coord = 0
        self.model = None

    def _lb_ub(self):
        return self.space.opt_lb.astype(float), self.space.opt_ub.astype(float)

    def _fit(self, Xv, yv):
        if self.model is None:
            self.model = get_model("gp", self.space, num_out=1, device=self.device,
                                   **self.model_config)
        ys = (yv - yv.mean()) / max(yv.std(), 1e-12)
        self.model.fit(Xv, ys.reshape(-1, 1))
        return ys

    def _new_direction(self, x0, Xv, ys):
        D = self.space.num_cols
        if self.mode == "coordinate":
            d = np.zeros(D)
            d[self._coord % D] = 1.0
            self._coord += 1
            return d
        if self.mode == "random":
            d = self.rng.standard_normal(D)
            return d / np.linalg.norm(d)
        if self.mode == "ascent":
            # the posterior mean's gradient at the incumbent (febo mean_grad_gp)
            state = self.model.state
            with torch.enable_grad():
                x = torch.as_tensor(np.asarray(x0, np.float32)[None, :],
                                    device=self.device).requires_grad_(True)
                mu, _ = self.model.predict_pure(state, x)
                g, = torch.autograd.grad(mu[0, 0], x)
            g = g[0].cpu().numpy().astype(float)
            n = np.linalg.norm(g)
            if not np.isfinite(n) or n < 1e-9:
                g = self.rng.standard_normal(D)
                n = np.linalg.norm(g)
            return -g / n  # descent direction (we minimize)
        raise ValueError(self.mode)

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if n_suggestions != 1:
            raise ValueError("subdomain BO is strictly sequential: suggest(1)")
        if self.num_obs < self.n_init:
            X = self.space.sobol_sample_opt(1, seed=self._sobol_count)
            self._sobol_count += 1
            return self.space.inverse_transform(X)

        X = self.space.transform(self.X).astype(np.float32)
        y = self.y[:, 0]
        ok = np.isfinite(y)
        Xv, yv = X[ok], y[ok]
        with timed(self.fit_time, self.device):
            ys = self._fit(Xv, yv)
        with timed(self.acq_time, self.device):
            return self.space.inverse_transform(self._search(Xv, ys)[None, :])

    def _search(self, Xv, ys):
        best = int(np.argmin(ys))
        x0 = Xv[best].astype(float)
        tau = float(ys[best])
        lb, ub = self._lb_ub()
        model, dev, state = self.model, self.device, self.model.state
        acq = LCB()
        params = AcqParams(kappa=self.kappa, tau=tau)

        def f_box(args, Xc):
            return acq.eval_pure(model, args[0], args[1], Xc)

        def acq_f(Xc):
            with torch.no_grad():
                Xt = torch.as_tensor(np.asarray(Xc, np.float32), device=dev)
                return acq.eval_pure(model, state, params, Xt).cpu().numpy()

        if self.mode == "tr":
            span = (ub - lb) * self.tr_radius
            tlb = np.maximum(lb, x0 - span / 2)
            tub = np.minimum(ub, x0 + span / 2)
            x_grid, _ = grid_solver(acq_f, tlb, tub,
                                    points_per_dim=max(3, int(round(200 ** (1 / len(lb))))))
            X0 = np.vstack([x_grid, self.rng.uniform(tlb, tub, (7, len(lb)))])
            x_best, _ = multi_start_lbfgs(f_box, X0, tlb, tub, n_iters=20, args=(state, params),
                                          device=dev)
            return x_best

        # line modes: the 1-D subdomain x0 + t d that stays in the box
        if self._phase_left <= 0 or self._direction is None:
            self._direction = self._new_direction(x0, Xv, ys)
            self._phase_left = self.line_steps
        self._phase_left -= 1
        d = self._direction
        with np.errstate(divide="ignore", invalid="ignore"):
            t_upper = np.where(d > 0, (ub - x0) / d, np.where(d < 0, (lb - x0) / d, np.inf))
            t_lower = np.where(d > 0, (lb - x0) / d, np.where(d < 0, (ub - x0) / d, -np.inf))
        t_hi, t_lo = float(np.min(t_upper)), float(np.max(t_lower))

        ts = np.linspace(t_lo, t_hi, 128)
        cands = x0[None, :] + ts[:, None] * d[None, :]
        i = int(np.argmin(acq_f(cands)[:, 0]))
        t_starts = np.clip(ts[i] + np.asarray([-0.02, 0.0, 0.02]) * (t_hi - t_lo), t_lo, t_hi)
        f32 = dict(dtype=torch.float32, device=dev)
        x0_t, d_t = torch.as_tensor(x0, **f32), torch.as_tensor(d, **f32)

        def f_line(args, T):  # T (B, 1): the line parameter
            return acq.eval_pure(model, args[0], args[1], args[2][None, :] + T * args[3][None, :])

        t_best, _ = multi_start_lbfgs(f_line, t_starts[:, None], np.asarray([t_lo]),
                                      np.asarray([t_hi]), n_iters=15,
                                      args=(state, params, x0_t, d_t), device=dev)
        x_new = np.clip(x0 + float(t_best[0]) * d, lb, ub)

        # the line's best grid point cannot beat the incumbent: end the phase
        mu, var = model.predict(cands[i : i + 1].astype(np.float32))
        if float(mu[0, 0] - self.kappa * math.sqrt(max(var[0, 0], 0.0))) > tau:
            self._phase_left = 0
        return x_new


def CoordinateLineBO(space, **kw):
    """febo CoordinateLineBO (subdomainbo.py:397)."""
    return SubDomainBO(space, mode="coordinate", **kw)


def RandomLineBO(space, **kw):
    """febo RandomLineBO (subdomainbo.py:417)."""
    return SubDomainBO(space, mode="random", **kw)


def AscentLineBO(space, **kw):
    """febo AscentLineBO (subdomainbo.py:428)."""
    return SubDomainBO(space, mode="ascent", **kw)
