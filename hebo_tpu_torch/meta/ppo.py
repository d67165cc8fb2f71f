"""PPO meta-training of the NAP acquisition policy (port of
``hebo_tpu/meta/ppo.py``).

An episode is sequential acquisition on a sampled function over a
candidate set, its reward the improvement of the best observed value;
PPO with GAE, the clipped surrogate and an entropy bonus trains a
transformer policy with a logit head over the candidates and a value head
(``NAPPolicy``, on the layers of ``nap.TransformerNP``: flax's Dense,
LayerNorm, tanh GELU and masked attention).  The environments are a batch
axis and an episode's steps a Python loop; tasks come from
``nap.sample_gp_tasks``, whose Gram is factored by kernel K1 on CUDA.

``ppo_train(mesh=...)`` is the JAX package's ``shard_map`` data
parallelism (ppo.py:322-337, the reference's DDP over NCCL): every rank
runs ``batch`` episodes of its own (its draws from a generator seeded from
(seed, rank)), and before each Adam step the gradient is averaged over the
ranks by one all-reduce (``pmean``), as is the mean regret; every rank then
holds the same parameters.  ``jax.checkpoint`` of each replay step's
forward is ``torch.utils.checkpoint``.

Every random number can be fed: an episode batch's task draws and the
Gumbel noise of its action draws (``RolloutDraws``; ``jax.random.categorical``
is the argmax of logits plus Gumbel noise), and pre-training's tasks and
context sizes.  Parameters are a dict of tensors (``named_parameters``),
applied with ``torch.func.functional_call``; ``policy_from_flax`` carries a
flax parameter tree across.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..models.gp.tree import adam_step
from ..parallel.sharded import all_reduce, mesh_size, rank_generator
from .nap import TaskDraws, _Block, _Dense, _FlaxTree, sample_gp_tasks

__all__ = ["NAPPolicy", "Transitions", "RolloutDraws", "ppo_train", "rollout_episodes",
           "filter_action_logits", "pretrain_policy", "policy_from_flax"]


def filter_action_logits(logits: torch.Tensor, top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Top-k and nucleus (top-p) filtering of acquisition logits
    (ppo.py:37-64): filtered entries become −1e9, the largest is always
    kept; ``top_k=0`` and ``top_p=1.0`` turn the filters off, and a
    ``top_k`` above the candidate count keeps every candidate."""
    neg = torch.full((), -1e9, dtype=logits.dtype, device=logits.device)
    if top_k and top_k > 0:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.sort(logits, -1).values[..., -k][..., None]
        logits = torch.where(logits < kth, neg, logits)
    if top_p < 1.0:
        srt = torch.sort(logits, -1, descending=True).values
        probs = torch.softmax(srt, -1)
        keep = (torch.cumsum(probs, -1) - probs) < top_p  # smallest prefix reaching top_p
        thr = torch.where(keep, srt, torch.full_like(srt, float("inf"))).min(-1, keepdim=True).values
        logits = torch.where(logits < thr, neg, logits)
    return logits


class NAPPolicy(nn.Module):
    """Transformer over (context, candidates) → per-candidate logits and a
    value (ppo.py:67-136): context tokens embed (x, y), candidate tokens
    (x, 0), and every token attends to the valid context tokens only; the
    value reads the mean of the valid context tokens.  ``single_stream``
    makes one token per candidate from (x, y·observed, observed), whose
    keys are the observed ones.  ``forward(..., return_mu=True)`` adds the
    posterior-mean head that pre-training fits (flax creates its
    parameters only when initialized with ``return_mu``)."""

    def __init__(self, dim_x: int, d_model: int = 64, n_heads: int = 4, n_layers: int = 2,
                 single_stream: bool = False, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.dim_x, self.d_model, self.n_layers = dim_x, d_model, n_layers
        self.single_stream = single_stream
        self.ctx_proj = _Dense(dim_x + (2 if single_stream else 1), d_model, device=device)
        self.qry_proj = None if single_stream else _Dense(dim_x + 1, d_model, device=device)
        self.blocks = nn.ModuleList(_Block(d_model, n_heads, device) for _ in range(n_layers))
        self.logit_head = _Dense(d_model, 1, device=device)
        self.value_head = _Dense(d_model, 1, device=device)
        self.mu_head = _Dense(d_model, 1, device=device)
        for m in self.modules():
            if isinstance(m, _Dense):
                m.reset(generator)

    def forward(self, Xc, yc, Xq, ctx_mask, return_mu: bool = False):
        """Xc (B, Nc, dx), yc (B, Nc, 1), Xq (B, Nq, dx), ctx_mask (B, Nc)
        bool → logits (B, Nq), value (B,) [, μ (B, Nq)]."""
        B, Nc, _ = Xc.shape
        if self.single_stream:
            flag = ctx_mask[..., None].to(Xc.dtype)
            h = self.ctx_proj(torch.cat([Xc, yc * flag, flag], -1))
            key_ok = ctx_mask
        else:
            Nq = Xq.shape[1]
            h = torch.cat([self.ctx_proj(torch.cat([Xc, yc], -1)),
                           self.qry_proj(torch.cat([Xq, Xq.new_zeros((B, Nq, 1))], -1))], 1)
            key_ok = torch.cat([ctx_mask, ctx_mask.new_zeros((B, Nq))], 1)
        for blk in self.blocks:
            h = blk(h, key_ok)
        hq = h if self.single_stream else h[:, Nc:]
        logits = self.logit_head(hq)[..., 0]
        m = ctx_mask.to(h.dtype)
        pool = (h[:, :Nc] * m[..., None]).sum(1) / torch.clamp(m.sum(1, keepdim=True), min=1.0)
        value = self.value_head(pool)[..., 0]
        if return_mu:
            return logits, value, self.mu_head(hq)[..., 0]
        return logits, value


class Transitions(NamedTuple):
    actions: torch.Tensor  # (T, B)
    log_probs: torch.Tensor  # (T, B)
    values: torch.Tensor  # (T, B)
    rewards: torch.Tensor  # (T, B)
    ys: torch.Tensor  # (T, B) the objective at the chosen candidate


class RolloutDraws(NamedTuple):
    """The random numbers of one batch of episodes: the tasks' draws and
    the Gumbel noise (T, B, C) of each step's action draw."""

    tasks: TaskDraws
    gumbel: torch.Tensor


def _gumbel(shape, generator, device) -> torch.Tensor:
    """Standard Gumbel noise −log(−log u), u uniform on [tiny, 1), as
    ``jax.random.gumbel``'s default mode."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))


def _params(policy: nn.Module, params: Optional[dict]) -> dict:
    return dict(policy.named_parameters()) if params is None else params


@torch.no_grad()
def rollout_episodes(policy: NAPPolicy, params: Optional[dict] = None,
                     generator: Optional[torch.Generator] = None, *, batch: int, n_cand: int,
                     horizon: int, top_k: int = 0, top_p: float = 1.0,
                     task_sampler: Optional[Callable] = None, n_init: int = 0,
                     span_reward: bool = False, draws: Optional[RolloutDraws] = None):
    """``batch`` BO episodes of ``horizon`` steps on fresh tasks of
    ``n_cand`` candidates (ppo.py:145-214).  Each step the policy scores
    the candidates, the observed ones are masked, the logits filtered
    (``top_k``, ``top_p``), and an action drawn; the reward is the
    improvement of the best value (scaled by the task's value span with
    ``span_reward``).  With ``n_init`` the first ``n_init`` candidates
    start observed, else none, with the batch's largest value as the best
    so far.
    ``task_sampler(batch, n_cand, dim_x, generator=...) -> (X, y)`` replaces
    the GP tasks.  Returns (transitions, X (B, C, dx), the mean final
    regret, (y observed, mask) at the episodes' start)."""
    dev = next(policy.parameters()).device
    p = _params(policy, params)
    if task_sampler is None:
        tasks = None if draws is None else TaskDraws(*(None if t is None else t.to(dev)
                                                       for t in draws.tasks))
        X, y = sample_gp_tasks(batch, n_cand, policy.dim_x, generator=generator, draws=tasks,
                               device=dev)
    else:
        X, y = task_sampler(batch, n_cand, policy.dim_x, generator=generator)
    y_flat = y[..., 0]
    y_min = y_flat.min(1).values
    r_scale = (1.0 / torch.clamp(y_flat.max(1).values - y_min, min=1e-6) if span_reward
               else torch.ones((batch,), device=dev))
    ar = torch.arange(batch, device=dev)
    if n_init > 0:
        mask = (torch.arange(n_cand, device=dev) < n_init)[None].expand(batch, n_cand).clone()
        yc = torch.where(mask, y_flat, torch.zeros_like(y_flat))
        best = torch.where(mask, y_flat, torch.full_like(y_flat, float("inf"))).min(1).values
    else:
        mask = torch.zeros((batch, n_cand), dtype=torch.bool, device=dev)
        yc = torch.zeros_like(y_flat)
        best = y_flat.max().expand(batch)  # pessimistic: the batch's largest value
    start = (yc, mask)
    steps = []
    for t in range(horizon):
        logits, value = functional_call(policy, p, (X, yc[..., None], X, mask))
        logits = torch.where(mask, torch.full_like(logits, -1e9), logits)
        logits = filter_action_logits(logits, top_k, top_p)
        g = _gumbel(logits.shape, generator, dev) if draws is None else draws.gumbel[t].to(dev)
        a = torch.argmax(g + logits, -1)
        logp = torch.log_softmax(logits, -1)[ar, a]
        y_a = y_flat[ar, a]
        new_best = torch.minimum(best, y_a)
        steps.append((a, logp, value, (best - new_best) * r_scale, y_a))
        best = new_best
        mask, yc = mask.clone(), yc.clone()
        mask[ar, a] = True
        yc[ar, a] = y_a
    trans = Transitions(*(torch.stack(t) for t in zip(*steps)))
    return trans, X, (best - y_min).mean(), start


def _gae(rewards: torch.Tensor, values: torch.Tensor, gamma: float = 0.99, lam: float = 0.95):
    """Generalized advantage estimates (T, B) and returns, with zero value
    after the last step (ppo.py:217-231)."""
    adv_next = v_next = torch.zeros_like(values[0])
    advs = []
    for t in range(rewards.shape[0] - 1, -1, -1):
        adv_next = rewards[t] + gamma * v_next - values[t] + gamma * lam * adv_next
        v_next = values[t]
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + values


def _ppo_loss(policy, p: dict, trans: Transitions, X, start, advs, returns, clip, vf_coef,
              ent_coef):
    """The PPO objective over a batch of episodes (ppo.py:290-318): the
    episode replayed from its start with the stored actions and values,
    each step's forward recomputed in the backward (checkpointed)."""
    yc, mask = start
    B = yc.shape[0]
    ar = torch.arange(B, device=yc.device)
    apply = lambda yc_, m_: functional_call(policy, p, (X, yc_[..., None], X, m_))
    pg, vf, ent = [], [], []
    for t in range(trans.actions.shape[0]):
        logits, value = checkpoint(apply, yc, mask, use_reentrant=False)
        logits = torch.where(mask, torch.full_like(logits, -1e9), logits)
        lsm = torch.log_softmax(logits, -1)
        a = trans.actions[t]
        ratio = torch.exp(lsm[ar, a] - trans.log_probs[t])
        s1 = ratio * advs[t]
        s2 = torch.clamp(ratio, 1 - clip, 1 + clip) * advs[t]
        pg.append(-torch.minimum(s1, s2).mean())
        vf.append(((value - returns[t]) ** 2).mean())
        ent.append((-(torch.softmax(logits, -1) * lsm).sum(-1)).mean())
        mask, yc = mask.clone(), yc.clone()
        mask[ar, a] = True
        yc[ar, a] = trans.ys[t]
    mean = lambda xs: torch.stack(xs).mean()
    return mean(pg) + vf_coef * mean(vf) - ent_coef * mean(ent)


def ppo_train(policy: NAPPolicy, seed: int = 0, *, n_iters: int = 20, batch: int = 16,
              n_cand: int = 24, horizon: int = 8, n_epochs: int = 2, clip: float = 0.2,
              lr: float = 3e-4, ent_coef: float = 0.01, vf_coef: float = 0.5, mesh=None,
              axis: str = "dp", task_sampler: Optional[Callable] = None, n_init: int = 0,
              init_params: Optional[dict] = None, eval_fn: Optional[Callable] = None,
              eval_every: int = 0, span_reward: bool = False,
              draws: Optional[Callable[[int], RolloutDraws]] = None,
              trace: Optional[list] = None):
    """PPO (ppo.py:234-362): per iteration ``batch`` episodes (``rollout_episodes``),
    GAE with normalized advantages, then ``n_epochs`` Adam steps
    (``optax.adam(lr)``) on the clipped objective.  Starts from
    ``init_params`` (e.g. ``pretrain_policy``'s) or the policy's own
    parameters.  With ``mesh`` each rank runs its own ``batch`` episodes and
    the gradient and the mean regret are averaged over the ranks; ``axis``
    must name the mesh's one axis.  Episodes draw
    from a generator seeded from (``seed``, rank) on the policy's device, or
    ``draws(iteration)`` gives this rank's.  ``eval_fn(params) -> float``
    (higher is better) is evaluated every ``eval_every`` iterations and at
    the end, and the best-scoring parameters are returned.  ``trace``, a
    list, receives each Adam step's (this rank's loss, the averaged
    gradient dict).  Returns
    (params dict, the mean regret per iteration (numpy))."""
    if mesh is not None and axis not in mesh.mesh_dim_names:
        raise ValueError(f"ppo_train: axis {axis!r} is not an axis of the mesh")
    dev = next(policy.parameters()).device
    gen = rank_generator(seed, mesh, dev)
    params = {k: v.detach().clone() for k, v in _params(policy, init_params).items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    world, count = mesh_size(mesh), 0
    regrets, best_score, best_params = [], -np.inf, params
    for it in range(n_iters):
        trans, X, mean_regret, start = rollout_episodes(
            policy, params, gen, batch=batch, n_cand=n_cand, horizon=horizon,
            task_sampler=task_sampler, n_init=n_init, span_reward=span_reward,
            draws=None if draws is None else draws(it))
        advs, returns = _gae(trans.rewards, trans.values)
        advs = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
        for _ in range(n_epochs):
            with torch.enable_grad():
                cur = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                loss = _ppo_loss(policy, cur, trans, X, start, advs, returns, clip, vf_coef,
                                 ent_coef)
                grads = torch.autograd.grad(loss, list(cur.values()), allow_unused=True)
            grads = [torch.zeros_like(v) if g is None else g for g, v in zip(grads, params.values())]
            if mesh is not None:  # pmean: one all-reduce of the packed gradient
                flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh) / world
                grads = list(torch.split(flat, [g.numel() for g in grads]))
                grads = [g.view(v.shape) for g, v in zip(grads, params.values())]
            count += 1
            for (k, v), g in zip(list(params.items()), grads):
                params[k], mu[k], nu[k] = adam_step(v, g, mu[k], nu[k], count, lr)
            if trace is not None:
                trace.append((loss.detach(), dict(zip(params, grads))))
        regrets.append(float(all_reduce(mean_regret, mesh) / world))
        if eval_fn is not None and eval_every and (it + 1) % eval_every == 0:
            score = float(eval_fn(params))
            if score > best_score:
                best_score, best_params = score, params
    if eval_fn is not None:
        if float(eval_fn(params)) > best_score:
            best_params = params
        return best_params, np.asarray(regrets)
    return params, np.asarray(regrets)


def pretrain_policy(policy: NAPPolicy, seed: int = 0, *, n_iters: int = 500, batch: int = 32,
                    n_cand: int = 128, task_sampler: Optional[Callable] = None,
                    n_obs_range=(5, 48), lr: float = 1e-3, ce_coef: float = 1.0,
                    mu_coef: float = 1.0, draws: Optional[Callable] = None):
    """Supervised pre-training of the policy (ppo.py:365-439): on tasks
    with a random number of observed candidates (uniform in
    ``n_obs_range``, the first ones of the task's random order), the logits
    learn by cross-entropy the unobserved candidate of least value, and the
    μ head regresses the unobserved values.  Adam from the policy's own
    parameters; draws from a generator seeded with ``seed``, or
    ``draws(step) -> (TaskDraws, n_obs (batch, 1))``.  Returns (params
    dict, the loss after each step (numpy))."""
    dev = next(policy.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    lo, hi = n_obs_range
    params = {k: v.detach().clone() for k, v in policy.named_parameters()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    ar = torch.arange(batch, device=dev)

    def loss_fn(p, X, yf, obs):
        yc = torch.where(obs, yf, torch.zeros_like(yf))
        logits, _, m = functional_call(policy, p, (X, yc[..., None], X, obs), {"return_mu": True})
        target = torch.argmin(torch.where(obs, torch.full_like(yf, float("inf")), yf), 1)
        logits = torch.where(obs, torch.full_like(logits, -1e9), logits)
        ce = -torch.log_softmax(logits, -1)[ar, target].mean()
        unobs = (~obs).to(yf.dtype)
        mse = (unobs * (m - yf) ** 2).sum() / torch.clamp(unobs.sum(), min=1.0)
        return ce_coef * ce + mu_coef * mse

    losses = []
    for s in range(n_iters):
        if draws is not None:
            task, nobs = draws(s)
            X, y = sample_gp_tasks(batch, n_cand, policy.dim_x, draws=task, device=dev)
        elif task_sampler is not None:
            X, y = task_sampler(batch, n_cand, policy.dim_x, generator=gen)
        else:
            X, y = sample_gp_tasks(batch, n_cand, policy.dim_x, generator=gen, device=dev)
        if draws is None:
            nobs = torch.randint(lo, hi + 1, (batch, 1), generator=gen, device=dev)
        obs = torch.arange(n_cand, device=dev)[None] < torch.as_tensor(nobs, device=dev)
        yf = y[..., 0]
        with torch.enable_grad():
            cur = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            grads = torch.autograd.grad(loss_fn(cur, X, yf, obs), list(cur.values()),
                                        allow_unused=True)
        for (k, v), g in zip(list(params.items()), grads):
            params[k], mu[k], nu[k] = adam_step(v, torch.zeros_like(v) if g is None else g,
                                                mu[k], nu[k], s + 1, lr)
        with torch.no_grad():
            losses.append(loss_fn(params, X, yf, obs))
    return params, torch.stack(losses).cpu().numpy()


def policy_from_flax(flax_params, policy: NAPPolicy) -> dict:
    """A flax ``NAPPolicy`` parameter tree → the port's parameter dict for
    ``policy`` (``nap.nap_from_flax``'s mapping of the trunk, then the logit
    and value heads and, where flax has it, ``mu_head``).  Flax names the
    token projections Dense_0 (and Dense_1 with two streams), each layer's
    feed-forward pair next, then the logit and the value head.  Every flax
    leaf must be used exactly once, and every parameter of ``policy`` set;
    a tree initialized without ``return_mu`` has no μ head, and then the
    policy's own μ head is kept."""
    tree, out = _FlaxTree(flax_params), {}
    n, first = policy.n_layers, 1 if policy.single_stream else 2
    tree.dense(out, "ctx_proj", "Dense_0")
    if not policy.single_stream:
        tree.dense(out, "qry_proj", "Dense_1")
    tree.blocks(out, n, first)
    tree.dense(out, "logit_head", f"Dense_{first + 2 * n}")
    tree.dense(out, "value_head", f"Dense_{first + 2 * n + 1}")
    keep = ()
    if "mu_head" in tree.top:
        tree.dense(out, "mu_head", "mu_head")
    else:
        keep = ("mu_head.weight", "mu_head.bias")
    return tree.state_dict(out, policy, keep)
