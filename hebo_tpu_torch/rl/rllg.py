"""RLLG: reinforcement learning with local guide policies (port of
``hebo_tpu/rl/rllg.py``).

Parity: RLLG (SAC variants with local guides): an expert "guide" policy is
trusted inside designated regions of the state space; the behavior policy
blends agent and guide actions with a state-dependent confidence λ(s),
and an auxiliary imitation loss pulls the learned policy toward the guide
where the guide is active.  λ decays over training so the agent gradually
takes over.  ``guide_fn`` and ``region_fn`` map an observation tensor to
the guide's action and the in-region indicator in [0, 1].
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .sac import SAC, SACState, adam_update

__all__ = ["GuidedSAC"]


class GuidedSAC(SAC):
    def __init__(
        self,
        obs_dim,
        act_dim,
        guide_fn: Callable[[torch.Tensor], torch.Tensor],
        region_fn: Callable[[torch.Tensor], torch.Tensor],
        act_limit=1.0,
        lambda0: float = 1.0,
        lambda_decay: float = 0.995,
        bc_coef: float = 0.5,
        **kw,
    ):
        super().__init__(obs_dim, act_dim, act_limit, **kw)
        self.guide_fn = guide_fn
        self.region_fn = region_fn  # obs → in-guide-region indicator [0,1]
        self.lam = lambda0
        self.lambda_decay = lambda_decay
        self.bc_coef = bc_coef

    # behavior policy: blend agent and guide inside the guide region
    def act(self, state: SACState, obs, generator: Optional[torch.Generator] = None,
            deterministic=False, eps=None):
        a = super().act(state, obs, generator, deterministic, eps)
        obs = torch.as_tensor(obs, dtype=a.dtype, device=self.device)
        g = self.guide_fn(obs)
        w = self.lam * self.region_fn(obs)
        if a.dim() > g.dim():
            g = g.expand(a.shape)
        w = w.reshape(-1, 1) if a.dim() == 2 else w
        return (1.0 - w) * a + w * g

    def decay(self):
        self.lam *= self.lambda_decay

    def _guided_update_impl(self, state: SACState, batch, eps) -> SACState:
        state = self._update_impl(state, batch, eps)
        obs = batch[0]
        # auxiliary BC loss toward the guide inside its region
        g = self.guide_fn(obs)
        w = self.region_fn(obs).reshape(-1, 1)
        pa = {k: v.detach().requires_grad_(True) for k, v in state.actor.items()}
        mu, _ = self._pi(pa, obs)
        a = torch.tanh(mu) * self.actor.act_limit
        gbc = torch.autograd.grad(torch.mean(w * (a - g) ** 2), list(pa.values()))
        # a second Adam step on the actor with the same moments: its count
        # advances twice in each guided update
        actor, opt_actor = adam_update(pa, {k: self.bc_coef * t for k, t in zip(pa, gbc)},
                                       state.opt_actor, self.lr)
        return state._replace(actor=actor, opt_actor=opt_actor)

    def update(self, state, batch, eps=None, generator: Optional[torch.Generator] = None):
        b = self._batch(state, batch)
        out = self._guided_update_impl(state, b, self._eps(state, b[0].shape[0], eps, generator))
        self.decay()
        return out
