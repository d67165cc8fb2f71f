"""DRiLLS-style RL baseline for logic synthesis (port of
``hebo_tpu/tasks/drills.py``; the BOiLS comparison agent).

An actor-critic agent builds a synthesis-operator sequence step by step.
The state after step t is the metrics of the prefix sequence (size/size0,
depth/depth0, step fraction, last QoR delta, a one-hot of the previous
operator); the reward is the QoR improvement.  The agent is a tanh MLP
with a policy head and a value head (``_PolicyValue``, flax's layer
defaults), trained by one advantage actor-critic step per episode
(discounted returns, entropy bonus) with the port's Adam
(``models/gp/tree.adam_step``, optax's defaults).  The synthesis calls stay
host subprocesses.

Every random number can be fed: ``run_episode(gumbels=)`` takes the
(seq_len, n_actions) Gumbel draws of the categorical sampling (the JAX
package's ``jax.random.categorical`` is the argmax of logits plus
Gumbel noise); ``policy_value_from_flax`` carries the JAX package's
network across.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..meta.nap import _Dense, _FlaxTree
from ..models.gp.tree import adam_step
from ..utils.device import resolve_device
from .boils import BoilsTask

__all__ = ["DrillsBaseline"]


class _PolicyValue(nn.Module):
    def __init__(self, feat_dim: int, n_actions: int, hidden: int = 32):
        super().__init__()
        self.l0 = _Dense(feat_dim, hidden)
        self.l1 = _Dense(hidden, hidden)
        self.pi = _Dense(hidden, n_actions)
        self.v = _Dense(hidden, 1)

    def reset(self, generator):
        for m in (self.l0, self.l1, self.pi, self.v):
            m.reset(generator)

    def forward(self, s):
        h = torch.tanh(self.l1(torch.tanh(self.l0(s))))
        return self.pi(h), self.v(h)[..., 0]


def policy_value_from_flax(flax_params, net: _PolicyValue) -> dict:
    """The JAX package's ``_PolicyValue`` params (Dense_0..3: the two hidden
    layers, the policy head, the value head) → ``net``'s parameter dict."""
    tree, out = _FlaxTree(flax_params), {}
    for name, flax_name in (("l0", "Dense_0"), ("l1", "Dense_1"), ("pi", "Dense_2"), ("v", "Dense_3")):
        tree.dense(out, name, flax_name)
    return tree.state_dict(out, net)


def _gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel draws, −log(−log u) with u in [tiny, 1) (as
    ``jax.random.gumbel``)."""
    u = torch.rand(shape, generator=generator, device=device).clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class DrillsBaseline:
    def __init__(
        self,
        task: Optional[BoilsTask] = None,
        hidden: int = 32,
        lr: float = 3e-3,
        gamma: float = 0.95,
        ent_coef: float = 0.01,
        vf_coef: float = 0.5,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.task = task or BoilsTask()
        self.ops = self.task.operators
        self.T = self.task.seq_len
        self.n_actions = len(self.ops)
        self.feat_dim = 4 + self.n_actions
        self.gamma = gamma
        self.lr = lr
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.net = _PolicyValue(self.feat_dim, self.n_actions, hidden).to(self.device)
        self.net.reset(self._gen)
        self.params = {k: v.detach().clone() for k, v in self.net.named_parameters()}
        self._mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self._nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self._count = 0
        self.ent_coef = ent_coef
        self.vf_coef = vf_coef
        self.best_qor = np.inf
        self.best_seq: list = []
        self.qor_trace: list = []

    # ---------------------------------------------------------------- agent
    def _act(self, s: np.ndarray, gumbel: torch.Tensor) -> int:
        """A categorical draw from the policy at state ``s``: the argmax of
        its logits plus the (n_actions,) Gumbel draw."""
        with torch.no_grad():
            logits, _ = functional_call(self.net, self.params,
                                        (torch.as_tensor(s, device=self.device)[None],))
            return int(torch.argmax(logits[0] + gumbel))

    def _update(self, S: np.ndarray, A: np.ndarray, R: np.ndarray) -> float:
        """One A2C step on an episode's states, actions and returns: the
        policy gradient with the value as baseline, the value's squared
        error and the entropy bonus; then one Adam step."""
        S, R = (torch.as_tensor(np.asarray(a, np.float32), device=self.device) for a in (S, R))
        A = torch.as_tensor(np.asarray(A, np.int64), device=self.device)
        with torch.enable_grad():
            cur = {k: v.requires_grad_(True) for k, v in self.params.items()}
            logits, v = functional_call(self.net, cur, (S,))
            logp_all = F.log_softmax(logits, -1)
            logp = logp_all[torch.arange(len(A), device=self.device), A]
            adv = R - v.detach()
            pg = -torch.mean(logp * adv)
            vf = torch.mean((v - R) ** 2)
            ent = -torch.mean(torch.sum(torch.softmax(logits, -1) * logp_all, -1))
            loss = pg + self.vf_coef * vf - self.ent_coef * ent
            grads = torch.autograd.grad(loss, list(cur.values()))
        self._count += 1
        for (k, p), g in zip(cur.items(), grads):
            self.params[k], self._mu[k], self._nu[k] = adam_step(
                p.detach(), g, self._mu[k], self._nu[k], self._count, self.lr)
        return float(loss.detach())

    # ------------------------------------------------------------------ env
    def _features(self, size_r, depth_r, t, delta, last_a):
        one_hot = np.zeros(self.n_actions, np.float32)
        if last_a >= 0:
            one_hot[last_a] = 1.0
        return np.concatenate(
            [np.asarray([size_r, depth_r, t / self.T, delta], np.float32), one_hot]
        )

    def run_episode(self, gumbels: Optional[torch.Tensor] = None):
        """One incremental synthesis episode; returns (seq, qor, S, A, R).
        ``gumbels`` (seq_len, n_actions) feeds the action draws."""
        if gumbels is None:
            gumbels = _gumbel((self.T, self.n_actions), self._gen, self.device)
        gumbels = torch.as_tensor(gumbels, dtype=torch.float32, device=self.device)
        prefix, states, actions, rewards = [], [], [], []
        qor = 2.0  # empty-sequence QoR is size0/size0 + depth0/depth0 = 2
        size_r = depth_r = 1.0
        delta, last_a = 0.0, -1
        for t in range(self.T):
            s = self._features(size_r, depth_r, t, delta, last_a)
            a = self._act(s, gumbels[t])
            prefix.append(self.ops[a])
            res = self.task.session.run_sequences([list(prefix)])[0]
            s0, d0 = self.task._base
            if res is not None:
                size_r = res[0] / max(s0, 1)
                depth_r = res[1] / max(d0, 1)
                new_qor = size_r + depth_r
            else:
                # failed synthesis: worst-case normalized QoR, and the ratio
                # features reset so the next state agrees with it
                size_r = depth_r = 1.0
                new_qor = 2.0
            delta = qor - new_qor
            states.append(s)
            actions.append(a)
            rewards.append(delta)
            qor = new_qor
            last_a = a
        return prefix, qor, np.stack(states), np.asarray(actions), np.asarray(rewards)

    # ------------------------------------------------------------------ train
    def returns(self, rew: np.ndarray) -> np.ndarray:
        """Discounted returns of an episode's rewards."""
        R = np.zeros(self.T, np.float32)
        acc = 0.0
        for t in range(self.T - 1, -1, -1):
            acc = rew[t] + self.gamma * acc
            R[t] = acc
        return R

    def train(self, n_episodes: int = 20) -> dict:
        for _ in range(n_episodes):
            seq, qor, S, A, rew = self.run_episode()
            self._update(S, A, self.returns(rew))
            self.qor_trace.append(float(qor))
            if qor < self.best_qor:
                self.best_qor, self.best_seq = float(qor), list(seq)
        return {
            "best_qor": self.best_qor,
            "best_seq": self.best_seq,
            "qor_trace": list(self.qor_trace),
        }
