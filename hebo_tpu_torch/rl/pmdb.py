"""PMDB: offline model-based RL with pessimism-modulated dynamics belief
(port of ``hebo_tpu/rl/pmdb.py``).

Parity: PMDB: learn an ensemble dynamics model from an offline dataset;
policy improvement uses imagined rollouts whose next-state distribution is
a *belief over ensemble members reweighted toward pessimistic (low-value)
predictions* — the sampling temperature modulates pessimism instead of an
explicit reward penalty.

On the device: the member axis leads every weight (as
``models/nn/deep_ensemble.py``'s ``MLPParams``), so all members train in
lockstep (``deep_ensemble.adam_fit``), one batched program per Adam step
with no host read; each member's minibatch indices are drawn from a
``torch.Generator`` or fed (``idx``).  The rollout's member picks are drawn as ``jax.random.choice``
turns a uniform into an index (the first member whose cumulative belief
reaches total·(1 − u)) or fed (``picks``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..models.nn.deep_ensemble import MLPParams, adam_fit, init_mlp
from ..utils.device import resolve_device

__all__ = ["DynamicsEnsemble", "pessimistic_rollout", "pick_members"]


def _dyn_forward(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    """x (N, d) or (E, N, d) → (E, N, obs_dim + 1): [Δobs | reward]."""
    E = p.w[0].shape[0]
    h = x.expand(E, *x.shape) if x.dim() == 2 else x
    for i, (w, b) in enumerate(zip(p.w, p.b)):
        h = torch.baddbmm(b[:, None, :], h, w)
        if i < len(p.w) - 1:
            h = torch.relu(h)
    return h


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class DynamicsEnsemble:
    """E-member MLP dynamics: (obs, act) → (Δobs, reward)."""

    def __init__(self, obs_dim, act_dim, n_members=5, hidden=64,
                 lr=1e-3, epochs=200, device="cuda"):
        self.device = resolve_device(device)
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.E = n_members
        self.sizes = [obs_dim + act_dim, hidden, hidden, obs_dim + 1]
        self.epochs = epochs
        self.lr = lr
        self.params: Optional[MLPParams] = None

    def fit(self, obs, act, next_obs, reward, idx=None,
            generator: Optional[torch.Generator] = None, init: Optional[MLPParams] = None):
        """Train every member ``epochs`` Adam steps on minibatches of
        min(256, n) rows: ``idx`` (E, epochs, min(256, n)) int rows (drawn
        from ``generator`` when not fed), from the weights ``init`` (drawn,
        √(2 / d_in)·N(0, 1) kernels and zero biases, when not fed)."""
        obs, act, next_obs, reward = (_host(a) for a in (obs, act, next_obs, reward))
        f32 = dict(dtype=torch.float32, device=self.device)
        X = torch.as_tensor(np.concatenate([obs, act], axis=1), **f32)
        Y = torch.as_tensor(np.concatenate([next_obs - obs, reward.reshape(-1, 1)], axis=1), **f32)
        n = X.shape[0]
        m = min(256, n)
        if idx is None:
            idx = torch.randint(0, n, (self.E, self.epochs, m), generator=generator, device=self.device)
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
        p = init if init is not None else init_mlp(self.E, self.sizes, generator, self.device)
        # each member's mean over its own rows: the sum that adam_fit
        # differentiates gives every member its own gradient
        self.params = adam_fit(p, lambda q, e: ((_dyn_forward(q, X[idx[:, e]]) - Y[idx[:, e]]) ** 2).mean((1, 2)),
                               self.epochs, self.lr)
        return self

    def predict_members(self, obs, act):
        """All members' (next_obs, reward): (E, B, obs_dim), (E, B)."""
        x = torch.cat([obs, act], -1)
        with torch.no_grad():
            out = _dyn_forward(self.params, x)
        return obs[None] + out[..., :-1], out[..., -1]


def pick_members(w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Members (B,) drawn from the beliefs ``w`` (E, B) with uniforms ``u``
    (B,) in [0, 1), as ``jax.random.choice(key, E, p=w[:, b])`` turns its
    uniform into an index: the first member whose cumulative belief
    reaches the total × (1 − u)."""
    cum = torch.cumsum(w, 0).T.contiguous()  # (B, E)
    r = cum[:, -1:] * (1 - u[:, None])
    return torch.searchsorted(cum, r)[:, 0].clamp(max=w.shape[0] - 1)


def pessimistic_rollout(
    ensemble: DynamicsEnsemble,
    policy_fn: Callable,
    obs0: torch.Tensor,
    horizon: int = 5,
    beta: float = 2.0,
    picks=None,
    generator: Optional[torch.Generator] = None,
):
    """Imagined rollout sampling members with belief weights
    softmax(-β·reward_member): β > 0 biases toward pessimistic members
    (the pessimism-modulated belief); β = 0 is the uniform belief.
    ``policy_fn(obs, generator)`` acts; ``picks`` (horizon, B) are the
    members, drawn from ``generator`` when not fed.

    Returns (obs_seq, act_seq, rew_seq) with leading time axis."""
    obs = obs0
    B = obs.shape[0]
    b_idx = torch.arange(B, device=obs.device)
    if picks is not None:
        picks = torch.as_tensor(picks, dtype=torch.long, device=obs.device)
    else:
        u = torch.rand((horizon, B), generator=generator, device=obs.device, dtype=obs.dtype)
    obs_seq, act_seq, rew_seq = [], [], []
    for t in range(horizon):
        act = policy_fn(obs, generator)
        nxt, rew = ensemble.predict_members(obs, act)  # (E, B, D), (E, B)
        w = torch.softmax(-beta * rew, dim=0)  # pessimistic belief
        m = picks[t] if picks is not None else pick_members(w, u[t])
        obs_seq.append(obs)
        act_seq.append(act)
        rew_seq.append(rew[m, b_idx])
        obs = nxt[m, b_idx]
    return torch.stack(obs_seq), torch.stack(act_seq), torch.stack(rew_seq)
