"""SIMMER: Sauté / Simmer safe RL via safety-state augmentation (port of
``hebo_tpu/rl/simmer.py``).

Parity: SIMMER:
  * **Sauté**: augment the observation with the remaining normalized
    safety budget  z' = z - cost/d  (d = episode budget); when the budget
    is exhausted (z < 0) the task reward is replaced by a penalty — safety
    becomes part of the dynamics instead of a Lagrangian term,
  * **Simmer**: a curriculum over budget levels driven by a PI controller
    on the observed episode cost — the budget is tightened when the agent
    over-spends and relaxed when it is safely under budget.

``SauteWrapper`` steps on the wrapped env's tensors and device;
``SimmerController`` is host arithmetic, the JAX package's copied.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SauteWrapper", "SimmerController"]


class SauteWrapper:
    """Wrap a tensor env with safety-state augmentation."""

    def __init__(self, env, budget: float = 5.0, horizon: int = 100,
                 unsafe_penalty: float = -1.0):
        self.env = env
        self.device = env.device
        self.budget = budget
        self.horizon = horizon
        self.unsafe_penalty = unsafe_penalty
        spec = env.spec
        self.spec = spec._replace(obs_dim=spec.obs_dim + 1)

    def reset(self, generator=None, u=None):
        state, obs = self.env.reset(generator, u)
        z = torch.ones((), dtype=obs.dtype, device=obs.device)  # normalized remaining budget
        return (state, z), torch.cat([obs, z[None]])

    def step(self, aug_state, action, generator=None):
        state, z = aug_state
        state, obs, reward, cost, done = self.env.step(state, action, generator)
        z = z - cost / max(self.budget, 1e-6)
        # Sauté reshaping: exhausted budget → penalty replaces reward
        reward = torch.where(z >= 0.0, reward, torch.full_like(reward, self.unsafe_penalty))
        aug_obs = torch.cat([obs, torch.clamp(z, min=-1.0)[..., None]], -1)
        return (state, z), aug_obs, reward, cost, done


class SimmerController:
    """PI controller scheduling the safety budget across training
    iterations (the 'simmering' curriculum)."""

    def __init__(self, target_cost: float, budget_min: float, budget_max: float,
                 kp: float = 0.2, ki: float = 0.05):
        self.target = target_cost
        self.budget_min = budget_min
        self.budget_max = budget_max
        self.kp, self.ki = kp, ki
        self.integral = 0.0
        self.budget = budget_max

    def update(self, observed_episode_cost: float) -> float:
        err = observed_episode_cost - self.target
        self.integral = float(np.clip(self.integral + err, -50.0, 50.0))
        # over-spend (err > 0) → tighten the budget; under → relax
        self.budget = float(
            np.clip(
                self.budget - self.kp * err - self.ki * self.integral,
                self.budget_min,
                self.budget_max,
            )
        )
        return self.budget
