"""Acquisition functions (port of ``hebo_tpu/acquisitions/acq.py``, :48-245).

Minimization convention: ``eval_pure(model, state, params, X)`` returns
(P, num_obj + num_constr), as in the JAX package; ``acq(model, X)``
evaluates on a fitted model and returns numpy.  ``model.predict_pure(state,
X)`` gives the raw-frame (mu, var).

``norm.logcdf``/``cdf``/``logpdf`` become ``torch.special.log_ndtr``,
``_ndtr`` and an explicit log-density; the z ≤ −6 asymptotic switch of
log EI is kept.  ``_ndtr`` is ½·erfc(−z/√2), as JAX's ``norm.cdf``:
``torch.special.ndtr`` in float32 cancels in the lower tail (Φ(−3.9) off by
2e-4 relative, Φ(−5.5) = 0), which moves log EI by 0.5 % at z ≈ −3.9.

MACE's noise-perturbed mean takes its standard normals in ``AcqParams.z``
(the JAX package draws them from a fixed key, so every evaluation of one
suggest sees the same draws).

``ThompsonSampling`` keeps the JAX package's key semantics: every
evaluation within one suggest draws from a generator on the model's device
seeded afresh with ``AcqParams.seed`` (the JAX package's
``PRNGKey(num_obs)``), so a whole acquisition search optimises one
posterior function draw.  An acquisition that needs its own standard
normals for a suggest (``NoisyAcq``'s shared ε) declares how many in
``n_normals``; HEBO draws them with the suggest's other random numbers and
passes them in ``AcqParams.draw``.  ``AddLCB`` sums the per-clique LCBs of
the random-decomposition GP (``gp_rd``), all cliques in one batched
posterior evaluation.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "AcqParams", "Acquisition", "LCB", "Mean", "Sigma", "EI", "PI", "UCB", "MACE",
    "ThompsonSampling", "CEI", "AddLCB", "MOMeanSigmaLCB", "GeneralAcq", "log_ei", "log_pi",
]

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class AcqParams(NamedTuple):
    """Per-iteration acquisition inputs (floats or 0-d tensors)."""

    tau: object = 0.0  # incumbent objective value
    kappa: object = 2.0  # LCB exploration weight
    eps: object = 1e-4  # EI/PI improvement slack
    noise: object = 0.0  # obs-noise scale of the perturbed mean
    z: Optional[torch.Tensor] = None  # (P, 1) standard normals, or None
    seed: Optional[int] = None  # Thompson sampling's draw (None: 0, as PRNGKey(0))
    draw: Optional[torch.Tensor] = None  # (1, n_normals) normals the acquisition declared


def _ndtr(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.special.erfc(-z * (1.0 / math.sqrt(2.0)))


def _norm_logpdf(z: torch.Tensor) -> torch.Tensor:
    return -0.5 * z * z - _LOG_SQRT_2PI


def log_pi(normed: torch.Tensor) -> torch.Tensor:
    return torch.special.log_ndtr(normed)


def log_ei(normed: torch.Tensor, log_sigma: torch.Tensor) -> torch.Tensor:
    """log EI, EI = σ(zΦ(z) + φ(z)); for z ≤ −6 the Mills-ratio asymptotic
    log φ(z) − log(z² − 1)."""
    z = normed
    direct = torch.log(torch.clamp(
        z * _ndtr(z) + torch.exp(_norm_logpdf(z)), min=1e-38))
    asymptotic = _norm_logpdf(z) - torch.log(torch.clamp(z * z - 1.0, min=1.0))
    return torch.where(z > -6.0, direct, asymptotic) + log_sigma


class Acquisition:
    num_obj: int = 1
    num_constr: int = 0
    n_normals: int = 0  # standard normals per suggest, passed in ``AcqParams.draw``

    @property
    def num_out(self) -> int:
        return self.num_obj + self.num_constr

    def eval_pure(self, model, state, params: AcqParams, X: torch.Tensor) -> torch.Tensor:
        """→ (P, num_obj + num_constr), minimization convention."""
        raise NotImplementedError

    def __call__(self, model, X, params: Optional[AcqParams] = None) -> np.ndarray:
        """Evaluation on a fitted model (``model.state``) at the opt-frame
        rows X, on the model's device, as numpy (acq.py:92-98)."""
        params = params if params is not None else AcqParams()
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=model.device)
        with torch.no_grad():
            return self.eval_pure(model, model.state, params, Xt).cpu().numpy()


def _predict(model, state, X):
    mu, var = model.predict_pure(state, X)
    return mu, torch.sqrt(torch.clamp(var, min=1e-12))


class LCB(Acquisition):
    """μ − κσ; κ comes from ``params.kappa``: the constructor's ``kappa`` is
    kept and not read, as in the JAX package (acq.py:110-115)."""

    def __init__(self, kappa: float = 2.0):
        self.kappa = kappa

    def eval_pure(self, model, state, params, X):
        mu, sigma = _predict(model, state, X)
        return mu - params.kappa * sigma


UCB = LCB


class Mean(Acquisition):
    def eval_pure(self, model, state, params, X):
        return _predict(model, state, X)[0]


class Sigma(Acquisition):
    """−σ: minimising it maximises the predictive uncertainty."""

    def eval_pure(self, model, state, params, X):
        return -_predict(model, state, X)[1]


class EI(Acquisition):
    def eval_pure(self, model, state, params, X):
        mu, sigma = _predict(model, state, X)
        normed = (params.tau - params.eps - mu) / sigma
        return -log_ei(normed, torch.log(sigma))


class PI(Acquisition):
    def eval_pure(self, model, state, params, X):
        mu, sigma = _predict(model, state, X)
        normed = (params.tau - params.eps - mu) / sigma
        return -log_pi(normed)


class MACE(Acquisition):
    """HEBO's acquisition: the three objectives (LCB, −log EI, −log PI)."""

    num_obj = 3

    def eval_pure(self, model, state, params, X):
        mu, sigma = _predict(model, state, X)
        if params.z is not None:
            mu = mu + math.sqrt(2.0) * params.noise * params.z
        lcb = mu - params.kappa * sigma
        normed = (params.tau - params.eps - mu) / sigma
        lei = log_ei(normed, torch.log(sigma))
        lpi = log_pi(normed)
        return torch.cat([lcb, -lei, -lpi], dim=-1)


class ThompsonSampling(Acquisition):
    """One posterior function draw (acq.py:182-199): ``model.joint_sample_pure``
    (the GP's joint draw, ``lin_reg``'s coefficient draw) where the model has
    it, else μ + εσ with one shared ε.  The generator is made on the model's
    device and seeded with ``params.seed`` at every evaluation, so the
    evaluations of one suggest see the same function."""

    def eval_pure(self, model, state, params, X):
        gen = torch.Generator(device=X.device)
        gen.manual_seed(0 if params.seed is None else int(params.seed))
        if hasattr(model, "joint_sample_pure"):
            return model.joint_sample_pure(state, gen, X)
        mu, sigma = _predict(model, state, X)
        eps = torch.randn((1, 1), generator=gen, dtype=mu.dtype, device=mu.device)
        return mu + eps * sigma


class CEI(Acquisition):
    """Constrained EI, −(log EI + Σ_i log Φ((λ_i − μ_i)/σ_i)) (acq.py:202-245):
    output 0 of the model is the objective, outputs 1..k the constraints
    with thresholds ``lambdas``.  ``augmented_ei`` multiplies EI by
    1 − σ_n/√(σ² + σ_n²); a non-finite ``params.tau`` scores feasibility
    alone.  One minimisation column."""

    def __init__(self, num_constr: int = 0, lambdas=None, augmented_ei: bool = False):
        self.num_constr = 0  # exposed as a single minimisation column
        self._n_constr = int(num_constr)
        self.lambdas = [0.0] * self._n_constr if lambdas is None else [float(v) for v in lambdas]
        self.augmented_ei = augmented_ei

    def eval_pure(self, model, state, params, X):
        mu, sigma = _predict(model, state, X)  # (P, 1 + n_constr)
        mu0, s0 = mu[:, :1], sigma[:, :1]
        tau = torch.as_tensor(params.tau, dtype=mu.dtype, device=mu.device)
        normed = (tau - params.eps - mu0) / s0
        lei = log_ei(normed, torch.log(s0))
        if self.augmented_ei:
            sn = torch.as_tensor(params.noise, dtype=mu.dtype, device=mu.device)
            lei = lei + torch.log(torch.clamp(
                1.0 - sn / torch.sqrt(s0 ** 2 + sn ** 2 + 1e-12), min=1e-12))
        if self._n_constr:
            lam = torch.as_tensor(self.lambdas, dtype=mu.dtype, device=mu.device)
            mc = mu[:, 1:1 + self._n_constr]
            sc = sigma[:, 1:1 + self._n_constr]
            lfeas = torch.special.log_ndtr((lam[None, :] - mc) / sc).sum(-1, keepdim=True)
        else:
            lfeas = torch.zeros_like(lei)
        return torch.where(torch.isfinite(tau), -(lei + lfeas), -lfeas)


class AddLCB(Acquisition):
    """Additive LCB over a random decomposition, Σ_c (μ_c − κσ_c) in the
    raw-y scale (acq.py:248-272; MCBO ``AddLCB``), for a model with the
    clique interface (``gp_rd``): every clique's posterior at X in one
    batched call, moment-matched over the hyperparameter samples.  κ comes
    from ``params.kappa``."""

    def eval_pure(self, model, state, params, X):
        samples, caches, data = state
        core = model.core
        C = core.n_cliques
        cs = torch.arange(C, device=X.device)
        mus, vars_ = core.predict_cliques(samples, caches, data, X.expand(C, -1, -1), cs)
        mu = mus.mean(0)  # (C, P, 1)
        var = torch.clamp((vars_ + mus ** 2).mean(0) - mu ** 2, min=1e-10)
        # component frame → raw scale (no mean shift)
        return (mu * data.y_std - params.kappa * torch.sqrt(var) * data.y_std).sum(0)


class MOMeanSigmaLCB(Acquisition):
    """Two objectives (μ, −σ) and one constraint, LCB − τ < 0 (acq.py:274)."""

    num_obj = 2
    num_constr = 1

    def eval_pure(self, model, state, params, X):
        mu, sigma = _predict(model, state, X)
        lcb = mu - params.kappa * sigma
        return torch.cat([mu, -sigma, lcb - params.tau], dim=-1)


class GeneralAcq(Acquisition):
    """GeneralBO's acquisition (acq.py:290): per-output LCB μ_i − κσ_i on
    the ``num_obj`` objectives, and μ_j − c_κ σ_j (feasible below 0) on the
    ``num_constr`` constraint outputs.  κ comes from ``params.kappa``, as
    in the JAX package: the constructor's ``kappa`` is kept and not read."""

    def __init__(self, num_obj: int, num_constr: int = 0, kappa: float = 2.0,
                 c_kappa: float = 0.0):
        self.num_obj = num_obj
        self.num_constr = num_constr
        self.kappa = kappa
        self.c_kappa = c_kappa

    def eval_pure(self, model, state, params, X):
        mu, sigma = _predict(model, state, X)  # (P, num_obj + num_constr)
        obj = mu[:, : self.num_obj] - params.kappa * sigma[:, : self.num_obj]
        if not self.num_constr:
            return obj
        constr = mu[:, self.num_obj :] - self.c_kappa * sigma[:, self.num_obj :]
        return torch.cat([obj, constr], dim=-1)
