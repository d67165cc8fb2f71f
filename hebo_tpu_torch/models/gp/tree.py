"""Pytree helpers over ``GPParams`` / ``GPCache`` tuples, dicts and nested
parameter tuples (SVGP's, the ensembles') (JAX's ``tree_leaves``,
``tree_map`` and ``ravel_pytree``, with ``None`` skipped as JAX's flattening
skips it), and the Adam step that the MAP fit, SVI and the ensembles share."""

from __future__ import annotations

import math
from typing import Any, Callable, List, Sequence

import numpy as np
import torch

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "Flat", "adam_step", "adam_train"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a tuple / NamedTuple or of a dict (sorted keys,
    as in JAX), nested ones included, depth first; ``None`` is skipped, as
    in JAX's flattening."""
    vals = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else list(tree)
    out = []
    for t in vals:
        if isinstance(t, (tuple, dict)):
            out.extend(tree_leaves(t))
        elif t is not None:
            out.append(t)
    return out


def tree_unflatten(like, leaves: Sequence[torch.Tensor]):
    """A tree of ``like``'s (nested) structure holding ``leaves`` in leaf order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, tuple):
            vals = [build(t) for t in node]
            return type(node)(*vals) if hasattr(node, "_fields") else tuple(vals)
        return next(it)

    return build(like)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` leaf by leaf over trees of one structure (``None`` kept)."""
    rl = [tree_leaves(r) for r in rest]
    return tree_unflatten(tree, [fn(t, *(r[i] for r in rl)) for i, t in enumerate(tree_leaves(tree))])


class Flat:
    """``ravel_pytree`` over a batched tree: every leaf (*lead, *shape) ↔
    one (*lead, dim) tensor, the leaves' flattened trailing axes side by
    side in leaf order."""

    def __init__(self, like, n_lead: int = 1):
        self.like = like
        self.shapes = [tuple(t.shape[n_lead:]) for t in tree_leaves(like)]
        self.sizes = [math.prod(s) for s in self.shapes]
        self.n_lead = n_lead
        self.dim = sum(self.sizes)

    def ravel(self, tree) -> torch.Tensor:
        ls = tree_leaves(tree)
        lead = ls[0].shape[: self.n_lead]
        return torch.cat([t.reshape(lead + (n,)) for t, n in zip(ls, self.sizes)], -1)

    def unravel(self, v: torch.Tensor):
        lead = tuple(v.shape[:-1])
        parts = torch.split(v, self.sizes, -1)
        return tree_unflatten(self.like, [p.reshape(lead + s) for p, s in zip(parts, self.shapes)])


def adam_step(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int,
              lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One step of ``optax.adam(lr)`` (bias-corrected moments) on a
    descent gradient g; returns (p, mu, nu).  As optax, the bias corrections
    1 − βᵗ are taken in the parameters' float type (for float32, numpy
    float32 scalars, which give XLA's ``1 - decay**count`` bit for bit) and
    the update is (m̂ / (√v̂ + ε)) · (−lr), then added."""
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g ** 2
    if p.dtype == torch.float64:
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
    else:
        one, t = np.float32(1), np.float32(count)
        c1, c2 = float(one - np.float32(b1) ** t), float(one - np.float32(b2) ** t)
    return p + (mu / c1) / (torch.sqrt(nu / c2) + eps) * (-lr), mu, nu


def adam_train(params: dict, loss_fn: Callable, n_steps: int, lr: float, step_input: Callable[[int], Any]):
    """``n_steps`` Adam steps (optax's) of ``loss_fn(params, step_input(s))``
    on a dict of tensors; a parameter the loss does not reach gets a zero
    gradient, which Adam leaves in place.  Adam is elementwise, so it steps
    all parameters as one flat vector (one ``adam_step`` per step, not one
    per tensor).  Returns (params, the losses (n_steps,) as numpy, read once
    at the end)."""
    keys = list(params)
    shapes, sizes = [params[k].shape for k in keys], [params[k].numel() for k in keys]
    flat = torch.cat([params[k].detach().reshape(-1) for k in keys])
    mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
    unflat = lambda v: {k: t.view(sh) for k, t, sh in zip(keys, torch.split(v, sizes), shapes)}
    losses = torch.empty((n_steps,), dtype=flat.dtype, device=flat.device)
    for s in range(n_steps):
        inp = step_input(s)
        with torch.enable_grad():
            cur = {k: t.detach().requires_grad_(True) for k, t in unflat(flat).items()}
            loss = loss_fn(cur, inp)
            grads = torch.autograd.grad(loss, list(cur.values()), allow_unused=True)
        losses[s] = loss.detach()
        g = torch.cat([(torch.zeros_like(t) if gt is None else gt).reshape(-1)
                       for t, gt in zip(cur.values(), grads)])
        flat, mu, nu = adam_step(flat, g, mu, nu, s + 1, lr)
    return unflat(flat), losses.cpu().numpy()
