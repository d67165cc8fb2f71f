"""Toy continuous-control environments on tensors (port of
``hebo_tpu/rl/envs.py``).

The reference RL subprojects run on MuJoCo / Safety-Gym / D4RL — external
simulators unavailable offline.  These analogs keep the same contract
(obs/action Boxes, reward + safety cost channels) as pure tensor
functions on the env's device, so whole rollouts stay there:

  * ``PointGoal`` — 2-D point mass steering to a goal with a circular
    hazard that emits safety cost (the Safety-Gym shape SIMMER uses),
  * ``Pendulum`` — classic swing-up (PMDB/RLLG-style dense control task).

``step`` is deterministic and takes one state (or a batch along leading
axes); it computes the JAX package's float32 arithmetic in its order.
``reset`` draws its uniforms from a ``torch.Generator`` or takes them fed
(``u`` in [0, 1)).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..utils.device import resolve_device

__all__ = ["EnvSpec", "PointGoal", "Pendulum"]


class EnvSpec(NamedTuple):
    obs_dim: int
    act_dim: int
    act_limit: float


class _Env:
    spec: EnvSpec

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _uniform(self, shape, generator, u, lo, hi) -> torch.Tensor:
        if u is None:
            u = torch.rand(shape, generator=generator, device=self.device)
        return lo + (hi - lo) * self._t(u)


class PointGoal(_Env):
    """State: [x, y, vx, vy]; goal at (1, 1); hazard disk at (0.5, 0.5)."""

    spec = EnvSpec(obs_dim=6, act_dim=2, act_limit=1.0)
    hazard_radius = 0.25
    dt = 0.1

    def __init__(self, device="cuda"):
        super().__init__(device)
        self.hazard_center = self._t([0.5, 0.5])
        self.goal = self._t([1.0, 1.0])

    def reset(self, generator: Optional[torch.Generator] = None, u=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        pos = self._uniform((2,), generator, u, -0.2, 0.2)
        state = torch.cat([pos, pos.new_zeros(2)])
        return state, self.obs(state)

    def obs(self, state):
        return torch.cat([state, self.goal - state[..., :2]], -1)

    def step(self, state, action, generator=None):
        action = self._t(action)
        pos, vel = state[..., :2], state[..., 2:]
        vel = 0.9 * vel + self.dt * torch.clamp(action, -1, 1)
        pos = pos + self.dt * vel
        state = torch.cat([pos, vel], -1)
        d = self.goal - pos
        dist = torch.sqrt((d * d).sum(-1))
        reward = -dist - 0.01 * (action ** 2).sum(-1)
        h = pos - self.hazard_center
        in_hazard = torch.sqrt((h * h).sum(-1)) < self.hazard_radius
        cost = in_hazard.to(torch.float32)
        done = dist < 0.05
        return state, self.obs(state), reward, cost, done


class Pendulum(_Env):
    spec = EnvSpec(obs_dim=3, act_dim=1, act_limit=2.0)
    dt = 0.05
    g, m, l = 10.0, 1.0, 1.0

    def reset(self, generator: Optional[torch.Generator] = None, u=None):
        th = self._uniform((), generator, u, -math.pi, math.pi)
        state = torch.stack([th, th.new_zeros(())])
        return state, self.obs(state)

    def obs(self, state):
        th, thdot = state[..., 0], state[..., 1]
        return torch.stack([torch.cos(th), torch.sin(th), thdot / 8.0], -1)

    def step(self, state, action, generator=None):
        action = self._t(action)
        th, thdot = state[..., 0], state[..., 1]
        lim = self.spec.act_limit
        u = torch.clamp(action[..., 0], -lim, lim)
        thdot = thdot + (
            3 * self.g / (2 * self.l) * torch.sin(th)
            + 3.0 / (self.m * self.l ** 2) * u
        ) * self.dt
        thdot = torch.clamp(thdot, -8.0, 8.0)
        th = th + thdot * self.dt
        state = torch.stack([th, thdot], -1)
        # floor-mod: torch.remainder takes the divisor's sign, as jnp's %
        th_norm = torch.remainder(th + math.pi, 2 * math.pi) - math.pi
        reward = -(th_norm ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2)
        cost = (torch.abs(thdot) > 7.0).to(torch.float32)
        return state, self.obs(state), reward, cost, torch.zeros_like(cost, dtype=torch.bool)
