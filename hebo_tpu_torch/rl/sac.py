"""Compact SAC in PyTorch — the shared engine for SIMMER / PMDB / RLLG
(port of ``hebo_tpu/rl/sac.py``).

Soft actor-critic with twin Q networks, target smoothing, and automatic
entropy tuning.  The networks are ``nn.Module`` templates with flax's
layout (``Dense`` layers with lecun-normal kernels and zero biases); their
weights live in ``SACState`` as dicts of tensors, applied with
``torch.func.functional_call``, and every update is optax's Adam
(``models.gp.tree.adam_step``) on the state's device.  An update's two
sets of reparameterisation normals (the target actions', the actor
loss's) are drawn from a ``torch.Generator`` or fed (``eps``), so a test
can feed the JAX package's.  The state computes in its parameters' float
type.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from ..meta.nap import _Dense
from ..models.gp.tree import adam_step
from ..utils.device import resolve_device

__all__ = ["SAC", "SACState", "AdamState", "ReplayBuffer", "Actor", "Critic"]

Params = Dict[str, torch.Tensor]


class _MLP(nn.Module):
    def __init__(self, d_in: int, out: int, hidden: int = 64, device=None):
        super().__init__()
        self.layers = nn.ModuleList([_Dense(d_in, hidden, device=device),
                                     _Dense(hidden, hidden, device=device),
                                     _Dense(hidden, out, device=device)])

    def forward(self, x):
        x = torch.relu(self.layers[0](x))
        x = torch.relu(self.layers[1](x))
        return self.layers[2](x)


class Actor(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, act_limit: float, hidden: int = 64, device=None):
        super().__init__()
        self.act_dim, self.act_limit = act_dim, act_limit
        self.mlp = _MLP(obs_dim, 2 * act_dim, hidden, device)

    def forward(self, obs):
        mu, log_std = torch.split(self.mlp(obs), self.act_dim, -1)
        return mu, torch.clamp(log_std, -6.0, 2.0)


class Critic(nn.Module):
    def __init__(self, obs_dim: int, act_dim: int, hidden: int = 64, device=None):
        super().__init__()
        self.mlp = _MLP(obs_dim + act_dim, 1, hidden, device)

    def forward(self, obs, act):
        return self.mlp(torch.cat([obs, act], -1))[..., 0]


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count and both moments."""

    count: int
    mu: Params
    nu: Params


def _adam_init(p: Params) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in p.items()},
                     {k: torch.zeros_like(v) for k, v in p.items()})


def adam_update(p: Params, g: Params, s: AdamState, lr: float) -> Tuple[Params, AdamState]:
    """One ``optax.adam(lr)`` step of every tensor of ``p``.  Adam is
    elementwise, so it steps them as one flat vector."""
    keys = list(p)
    flat = lambda d: torch.cat([d[k].detach().reshape(-1) for k in keys])
    unflat = lambda v: {k: t.view_as(p[k]) for k, t in zip(keys, torch.split(v, [p[k].numel() for k in keys]))}
    new, mu, nu = adam_step(flat(p), flat(g), flat(s.mu), flat(s.nu), s.count + 1, lr)
    return unflat(new), AdamState(s.count + 1, unflat(mu), unflat(nu))


class SACState(NamedTuple):
    actor: Params
    q1: Params
    q2: Params
    q1_targ: Params
    q2_targ: Params
    log_alpha: torch.Tensor
    opt_actor: AdamState
    opt_q: AdamState  # one state over the pair, keys "q1.<name>" / "q2.<name>"
    opt_alpha: AdamState  # over {"log_alpha": log_alpha}


class ReplayBuffer:
    """Host ring buffer (copy of the JAX package's): the same ``rng`` gives
    the same batch."""

    def __init__(self, obs_dim, act_dim, size=100_000):
        self.obs = np.zeros((size, obs_dim), np.float32)
        self.act = np.zeros((size, act_dim), np.float32)
        self.rew = np.zeros(size, np.float32)
        self.nobs = np.zeros((size, obs_dim), np.float32)
        self.done = np.zeros(size, np.float32)
        self.cost = np.zeros(size, np.float32)
        self.ptr = 0
        self.n = 0
        self.size = size

    def add(self, o, a, r, no, d, c=0.0):
        i = self.ptr
        self.obs[i], self.act[i], self.rew[i] = o, a, r
        self.nobs[i], self.done[i], self.cost[i] = no, d, c
        self.ptr = (i + 1) % self.size
        self.n = min(self.n + 1, self.size)

    def sample(self, rng, batch):
        idx = rng.integers(0, self.n, batch)
        return (
            self.obs[idx], self.act[idx], self.rew[idx],
            self.nobs[idx], self.done[idx], self.cost[idx],
        )


def _split(p: Params, prefix: str) -> Params:
    n = len(prefix)
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix)}


class SAC:
    def __init__(self, obs_dim, act_dim, act_limit=1.0, hidden=64,
                 gamma=0.99, tau=0.005, lr=3e-4, target_entropy=None, device="cuda"):
        self.device = resolve_device(device)
        self.actor = Actor(obs_dim, act_dim, act_limit, hidden, self.device)
        self.q1 = Critic(obs_dim, act_dim, hidden, self.device)
        self.q2 = Critic(obs_dim, act_dim, hidden, self.device)
        self.gamma, self.tau, self.lr = gamma, tau, lr
        self.obs_dim, self.act_dim = obs_dim, act_dim
        self.target_entropy = (
            target_entropy if target_entropy is not None else -float(act_dim)
        )

    def init(self, generator: Optional[torch.Generator] = None) -> SACState:
        """Fresh weights (flax's Dense init) drawn from ``generator``."""
        params = []
        for net in (self.actor, self.q1, self.q2):
            for m in net.modules():
                if isinstance(m, _Dense):
                    m.reset(generator)
            params.append({k: v.detach().clone() for k, v in net.named_parameters()})
        pa, p1, p2 = params
        return self.state_from(pa, p1, p2)

    def state_from(self, pa: Params, p1: Params, p2: Params) -> SACState:
        """The state at the start of training from these weights (the
        targets copy the critics; zero Adam moments; log α = 0)."""
        la = torch.zeros((), dtype=next(iter(pa.values())).dtype, device=self.device)
        return SACState(
            actor=pa, q1=p1, q2=p2, q1_targ=dict(p1), q2_targ=dict(p2), log_alpha=la,
            opt_actor=_adam_init(pa),
            opt_q=_adam_init({**{f"q1.{k}": v for k, v in p1.items()},
                              **{f"q2.{k}": v for k, v in p2.items()}}),
            opt_alpha=_adam_init({"log_alpha": la}),
        )

    # ------------------------------------------------------------ networks
    def _pi(self, pa: Params, obs):
        return functional_call(self.actor, pa, (obs,))

    def _q(self, net, p: Params, obs, act):
        return functional_call(net, p, (obs, act))

    def _sample(self, pa: Params, obs, eps):
        mu, log_std = self._pi(pa, obs)
        pre = mu + torch.exp(log_std) * eps
        lim = self.actor.act_limit
        a = torch.tanh(pre) * lim
        logp = torch.sum(
            -0.5 * (eps ** 2 + 2 * log_std + np.log(2 * np.pi))
            - torch.log(lim * (1 - torch.tanh(pre) ** 2) + 1e-6),
            -1,
        )
        return a, logp

    def _dtype(self, state: SACState):
        return state.log_alpha.dtype

    def _normals(self, shape, state, generator):
        return torch.randn(shape, generator=generator, device=self.device, dtype=self._dtype(state))

    def act(self, state: SACState, obs, generator: Optional[torch.Generator] = None,
            deterministic=False, eps=None):
        """The policy's action at ``obs``: tanh(μ)·limit when
        ``deterministic``, else a reparameterised draw with normals ``eps``
        (drawn from ``generator`` when not fed)."""
        obs = torch.as_tensor(obs, dtype=self._dtype(state), device=self.device)
        with torch.no_grad():
            if deterministic:
                mu, _ = self._pi(state.actor, obs)
                return torch.tanh(mu) * self.actor.act_limit
            if eps is None:
                eps = self._normals(obs.shape[:-1] + (self.act_dim,), state, generator)
            a, _ = self._sample(state.actor, obs, torch.as_tensor(eps, dtype=obs.dtype, device=self.device))
            return a

    # -------------------------------------------------------------- update
    def _batch(self, state, batch):
        return tuple(torch.as_tensor(b, dtype=self._dtype(state), device=self.device) for b in batch[:5])

    def _update_impl(self, state: SACState, batch, eps) -> SACState:
        obs, act, rew, nobs, done = batch
        eps_targ, eps_pi = eps
        alpha = torch.exp(state.log_alpha)

        # targets
        with torch.no_grad():
            na, nlogp = self._sample(state.actor, nobs, eps_targ)
            q_targ = torch.minimum(self._q(self.q1, state.q1_targ, nobs, na),
                                   self._q(self.q2, state.q2_targ, nobs, na))
            backup = rew + self.gamma * (1.0 - done) * (q_targ - alpha * nlogp)

        qp = {**{f"q1.{k}": v.detach().requires_grad_(True) for k, v in state.q1.items()},
              **{f"q2.{k}": v.detach().requires_grad_(True) for k, v in state.q2.items()}}
        l1 = torch.mean((self._q(self.q1, _split(qp, "q1."), obs, act) - backup) ** 2)
        l2 = torch.mean((self._q(self.q2, _split(qp, "q2."), obs, act) - backup) ** 2)
        gq = dict(zip(qp, torch.autograd.grad(l1 + l2, list(qp.values()))))
        qn, opt_q = adam_update(qp, gq, state.opt_q, self.lr)
        q1, q2 = _split(qn, "q1."), _split(qn, "q2.")

        pa = {k: v.detach().requires_grad_(True) for k, v in state.actor.items()}
        a, logp = self._sample(pa, obs, eps_pi)
        q = torch.minimum(self._q(self.q1, q1, obs, a), self._q(self.q2, q2, obs, a))
        la = torch.mean(alpha * logp - q)
        mean_logp = torch.mean(logp).detach()
        ga = dict(zip(pa, torch.autograd.grad(la, list(pa.values()))))
        actor, opt_actor = adam_update(pa, ga, state.opt_actor, self.lr)

        # d/d log α of −exp(log α)·(mean log π + target entropy)
        gal = -torch.exp(state.log_alpha) * (mean_logp + self.target_entropy)
        la_new, opt_alpha = adam_update({"log_alpha": state.log_alpha}, {"log_alpha": gal},
                                        state.opt_alpha, self.lr)

        tau = self.tau
        q1_targ = {k: (1 - tau) * t + tau * q1[k] for k, t in state.q1_targ.items()}
        q2_targ = {k: (1 - tau) * t + tau * q2[k] for k, t in state.q2_targ.items()}
        return SACState(actor, q1, q2, q1_targ, q2_targ, la_new["log_alpha"],
                        opt_actor, opt_q, opt_alpha)

    def _eps(self, state, B, eps, generator):
        if eps is None:
            shape = (B, self.act_dim)
            return self._normals(shape, state, generator), self._normals(shape, state, generator)
        return tuple(torch.as_tensor(e, dtype=self._dtype(state), device=self.device) for e in eps)

    def update(self, state: SACState, batch, eps=None,
               generator: Optional[torch.Generator] = None) -> SACState:
        """One SAC update on ``batch`` (obs, act, rew, nobs, done[, cost]:
        the cost column is dropped).  ``eps`` = (the target actions'
        normals, the actor loss's), each (B, act_dim); drawn from
        ``generator`` when not fed."""
        b = self._batch(state, batch)
        return self._update_impl(state, b, self._eps(state, b[0].shape[0], eps, generator))
