"""Pytree helpers over ``GPParams`` / ``GPCache`` tuples and dicts (JAX's
``tree_leaves``, ``tree_map`` and ``ravel_pytree``, with ``None`` skipped as
JAX's flattening skips it), and the Adam step that the MAP fit and SVI
share."""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "Flat", "adam_step"]


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a tuple / NamedTuple (``None`` skipped, as in JAX's
    flattening) or of a dict (sorted keys, as in JAX)."""
    vals = [tree[k] for k in sorted(tree)] if isinstance(tree, dict) else list(tree)
    return [t for t in vals if t is not None]


def tree_unflatten(like, leaves: Sequence[torch.Tensor]):
    """A tree of ``like``'s structure holding ``leaves`` in leaf order."""
    it = iter(leaves)
    if isinstance(like, dict):
        out = {k: next(it) for k in sorted(like)}
        return {k: out[k] for k in like}
    return type(like)(*(None if t is None else next(it) for t in like))


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
    descent gradient g; returns (p, mu, nu)."""
    mu = b1 * mu + (1 - b1) * g
    nu = b2 * nu + (1 - b2) * g ** 2
    mhat = mu / (1 - b1 ** count)
    vhat = nu / (1 - b2 ** count)
    return p + (-lr * mhat / (torch.sqrt(vhat) + eps)), mu, nu
