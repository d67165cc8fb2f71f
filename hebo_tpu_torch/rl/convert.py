"""Carry the RL networks' weights over from the JAX package.

The inputs are the JAX package's flax parameter trees and named tuples of
arrays, read through ``np.asarray`` (no JAX import here):
``sac_from_flax`` for a whole ``SACState`` (the actor, both critics, their
targets, log α and the three Adam states) and ``dynamics_from_jax`` for a
``DynamicsEnsemble``'s ``MLPParams``.  Each places the values on the port
model's device; a flax ``Dense`` kernel (in, out) becomes the transposed
``Linear`` weight.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.convert import ensemble_from_jax
from ..models.nn.deep_ensemble import MLPParams
from .pmdb import DynamicsEnsemble
from .sac import SAC, AdamState, SACState

__all__ = ["sac_from_flax", "dynamics_from_jax"]


def _mlp(tree, dev) -> dict:
    """A flax ``Actor`` / ``Critic`` tree (with or without the ``"params"``
    level) → the port module's parameter dict."""
    t = tree.get("params", tree)["_MLP_0"]
    out = {}
    for i in range(3):
        d = t[f"Dense_{i}"]
        out[f"mlp.layers.{i}.weight"] = torch.as_tensor(np.array(d["kernel"], np.float32).T.copy(), device=dev)
        out[f"mlp.layers.{i}.bias"] = torch.as_tensor(np.array(d["bias"], np.float32), device=dev)
    return out


def _adam(opt_state, prefixes, dev) -> AdamState:
    """optax's ``(ScaleByAdamState, EmptyState)`` of adam → ``AdamState``
    keyed as the port's: one flax tree per prefix (the critics' pair is a
    tuple of two), or log α's scalar."""
    s = opt_state[0]
    f32 = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
    if prefixes == ("log_alpha",):
        return AdamState(int(np.asarray(s.count)), {"log_alpha": f32(s.mu)}, {"log_alpha": f32(s.nu)})
    mus, nus = (s.mu, s.nu) if len(prefixes) > 1 else ((s.mu,), (s.nu,))
    mu, nu = {}, {}
    for prefix, m, n in zip(prefixes, mus, nus):
        mu.update({prefix + k: v for k, v in _mlp(m, dev).items()})
        nu.update({prefix + k: v for k, v in _mlp(n, dev).items()})
    return AdamState(int(np.asarray(s.count)), mu, nu)


def sac_from_flax(jax_state, sac: SAC) -> SACState:
    """A JAX ``SACState`` → the port's ``SACState`` on ``sac``'s device."""
    dev = sac.device
    return SACState(
        actor=_mlp(jax_state.actor, dev), q1=_mlp(jax_state.q1, dev), q2=_mlp(jax_state.q2, dev),
        q1_targ=_mlp(jax_state.q1_targ, dev), q2_targ=_mlp(jax_state.q2_targ, dev),
        log_alpha=torch.as_tensor(np.array(jax_state.log_alpha, np.float32), device=dev),
        opt_actor=_adam(jax_state.opt_actor, ("",), dev),
        opt_q=_adam(jax_state.opt_q, ("q1.", "q2."), dev),
        opt_alpha=_adam(jax_state.opt_alpha, ("log_alpha",), dev),
    )


def dynamics_from_jax(params, ensemble: DynamicsEnsemble) -> MLPParams:
    """A JAX ``DynamicsEnsemble``'s ``MLPParams`` (member axis first) → the
    port's on ``ensemble``'s device."""
    return ensemble_from_jax(params, ensemble.device)
