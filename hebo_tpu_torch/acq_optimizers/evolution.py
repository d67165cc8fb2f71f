"""Mixed-variable NSGA-II acquisition optimizer on the device.

Port of ``hebo_tpu/acq_optimizers/evolution.py`` (:48-185).  The population
(P, D) is the leading axis; the generations are a Python loop.  The search
distribution is pymoo's MixedVariableMating: SBX crossover + polynomial
mutation on continuous columns, uniform crossover + random reset on
categorical columns, binary tournament on (rank, crowding) and (μ+λ)
survival.

The JAX package draws each generation's random numbers from split keys.
Here they come from a ``torch.Generator`` on the device, or from a
``draws(gen) → GenDraws`` callable, so that a test can feed the JAX draws
and a captured CUDA graph can read them from buffers filled before replay.
On CUDA, the tournament's keys and the survivors' order are each one launch
of kernel K5 (``ops/pareto.nsga2_select``): no sort per generation.

``EvolutionOpt`` is the host-side wrapper with the reference API
(evolution.py:191-276), which HEBO's generic route drives: a Sobol initial
population, the incumbent injected, the ``fix_input`` columns written, and
the loop run on the model's device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..acquisitions.acq import AcqParams
from ..ops.pareto import nsga2_select

__all__ = ["EvolveSpaceMeta", "EvolutionOpt", "GenDraws", "MetaTensors", "evolve_raw",
           "draw_generation", "meta_tensors"]


class EvolveSpaceMeta(NamedTuple):
    """Static column metadata of the search space."""

    lb: Tuple[float, ...]
    ub: Tuple[float, ...]
    is_discrete: Tuple[bool, ...]  # rounded at evaluation and on output
    is_cat: Tuple[bool, ...]  # random-reset mutation instead of polynomial
    fix_mask: Tuple[bool, ...] = ()  # fixed (contextual) columns


class GenDraws(NamedTuple):
    """One generation's random numbers: tournament indices (2, P) and
    uniforms (P, D) for SBX (3), mutation (2) and the categorical ops (3)."""

    sel: torch.Tensor
    sbx_u: torch.Tensor
    sbx_do: torch.Tensor
    sbx_swap: torch.Tensor
    mut_u: torch.Tensor
    mut_do: torch.Tensor
    cat_take: torch.Tensor
    cat_reset: torch.Tensor
    cat_u: torch.Tensor


def _space_meta(space, fix_input=None) -> EvolveSpaceMeta:
    D = space.num_cols
    is_cat = [False] * D
    for c in space.cat_dims:
        is_cat[c] = True
    is_disc = [False] * D
    for c in space.cat_dims + space.discrete_numeric_dims + space.perm_dims:
        is_disc[c] = True
    fix = [False] * D
    for name in fix_input or ():
        c0 = space._col_of[name]
        for j in range(space.params[name].num_cols):
            fix[c0 + j] = True
    return EvolveSpaceMeta(
        lb=tuple(space.opt_lb.tolist()), ub=tuple(space.opt_ub.tolist()),
        is_discrete=tuple(is_disc), is_cat=tuple(is_cat), fix_mask=tuple(fix),
    )


class MetaTensors(NamedTuple):
    """``EvolveSpaceMeta`` as tensors on the device (D,) each."""

    lb: torch.Tensor
    ub: torch.Tensor
    is_discrete: torch.Tensor
    is_cat: torch.Tensor
    fix: torch.Tensor


def meta_tensors(meta: EvolveSpaceMeta, device) -> MetaTensors:
    """Copy the column metadata to ``device`` once, outside any captured
    graph (a host-to-device copy cannot be captured)."""
    D = len(meta.lb)
    f32 = dict(dtype=torch.float32, device=device)
    return MetaTensors(
        lb=torch.as_tensor(meta.lb, **f32), ub=torch.as_tensor(meta.ub, **f32),
        is_discrete=torch.as_tensor(meta.is_discrete, dtype=torch.bool, device=device),
        is_cat=torch.as_tensor(meta.is_cat, dtype=torch.bool, device=device),
        fix=torch.as_tensor(meta.fix_mask if meta.fix_mask else (False,) * D,
                            dtype=torch.bool, device=device),
    )


def _round_discrete(X: torch.Tensor, mt: MetaTensors) -> torch.Tensor:
    return _clip(torch.where(mt.is_discrete[None, :], torch.round(X), X), mt.lb, mt.ub)


def _clip(x, lb, ub):
    return torch.minimum(torch.maximum(x, lb), ub)


def _sbx_crossover(p1, p2, lb, ub, u, do_u, swap_u, eta=15.0, prob=0.9):
    """Simulated binary crossover per column (pymoo-compatible)."""
    e = 1.0 / (eta + 1.0)
    beta = torch.where(u <= 0.5, (2.0 * u) ** e, (1.0 / (2.0 * (1.0 - u) + 1e-12)) ** e)
    c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
    c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
    child = torch.where(swap_u < 0.5, c1, c2)
    child = torch.where(do_u < prob, child, p1)
    return _clip(child, lb, ub)


def _poly_mutation(x, lb, ub, u, do_u, eta=20.0, prob=None):
    """Polynomial mutation (pymoo-compatible)."""
    prob = 1.0 / x.shape[-1] if prob is None else prob
    span = ub - lb
    delta1 = (x - lb) / (span + 1e-12)
    delta2 = (ub - x) / (span + 1e-12)
    e = 1.0 / (eta + 1.0)
    lo = (2.0 * u + (1.0 - 2.0 * u) * (1.0 - delta1) ** (eta + 1.0)) ** e - 1.0
    hi = 1.0 - (2.0 * (1.0 - u) + 2.0 * (u - 0.5) * (1.0 - delta2) ** (eta + 1.0)) ** e
    deltaq = torch.where(u <= 0.5, lo, hi)
    return _clip(torch.where(do_u < prob, x + deltaq * span, x), lb, ub)


def _cat_ops(p1, p2, lb, ub, take_u, reset_u, u, prob_mut=None):
    """Uniform crossover + random-reset mutation for categorical columns."""
    prob_mut = 1.0 / p1.shape[-1] if prob_mut is None else prob_mut
    child = torch.where(take_u < 0.5, p2, p1)
    rand_cat = torch.floor(lb + u * (ub - lb + 1.0))
    return torch.where(reset_u < prob_mut, _clip(rand_cat, lb, ub), child)


def draw_generation(P: int, D: int, generator: Optional[torch.Generator],
                    device) -> GenDraws:
    """One generation's draws from ``generator``."""
    u = lambda: torch.rand((P, D), generator=generator, device=device)
    sel = torch.randint(0, P, (2, P), generator=generator, device=device)
    return GenDraws(sel, u(), u(), u(), u(), u(), u(), u(), u())


def evolve_raw(
    init_pop: torch.Tensor,
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    meta: EvolveSpaceMeta,
    n_gens: int = 100,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Callable[[int], GenDraws]] = None,
    mt: Optional[MetaTensors] = None,
):
    """NSGA-II loop.  ``eval_fn(X (P, D)) → (P, n_obj)``.  Returns the final
    population (rounded) and its objectives.  ``mt`` is ``meta`` on the
    device (``meta_tensors``), made here when not given."""
    P, D = init_pop.shape
    dev = init_pop.device
    mt = meta_tensors(meta, dev) if mt is None else mt
    lb, ub, cat, fix = mt.lb, mt.ub, mt.is_cat, mt.fix

    def evaluate(X):
        return eval_fn(_round_discrete(X, mt))

    X = init_pop
    F = evaluate(X)
    for g in range(n_gens):
        dr = draws(g) if draws is not None else draw_generation(P, D, generator, dev)
        skey = nsga2_select(F)[2]
        sel = dr.sel.long()
        win = torch.where(skey[sel[0]] <= skey[sel[1]], sel[0], sel[1])
        mate = torch.roll(win, 1)
        p1, p2 = X[win], X[mate]
        child_c = _sbx_crossover(p1, p2, lb, ub, dr.sbx_u, dr.sbx_do, dr.sbx_swap)
        child_c = _poly_mutation(child_c, lb, ub, dr.mut_u, dr.mut_do)
        child_k = _cat_ops(p1, p2, lb, ub, dr.cat_take, dr.cat_reset, dr.cat_u)
        child = torch.where(cat[None, :], child_k, child_c)
        child = torch.where(fix[None, :], p1, child)
        Fc = evaluate(child)
        Xall = torch.cat([X, child], 0)
        Fall = torch.cat([F, Fc], 0)
        order = nsga2_select(Fall, P)[3]
        X, F = Xall[order], Fall[order]
    return _round_discrete(X, mt), F


class EvolutionOpt:
    """The reference ``EvolutionOpt`` API over ``evolve_raw``.  ``es`` is
    accepted and ignored, as in the JAX package: with one objective the
    rank is constant and the tournament and survival order by crowding
    alone.  The loop runs on the model's device."""

    def __init__(self, space, acq, pop: int = 100, iters: int = 100, es: Optional[str] = None):
        self.space = space
        self.acq = acq
        self.pop = pop
        self.iters = iters

    def optimize(self, model=None, acq_params: Optional[AcqParams] = None,
                 initial_suggest: Optional[np.ndarray] = None, fix_input: Optional[dict] = None,
                 return_pop: bool = False, seed: int = 0,
                 draws: Optional[Callable[[int], GenDraws]] = None):
        """Opt-frame best point (1, D), or with ``return_pop`` the rounded
        population (P, D) and its objectives (P, n_obj).  The generations'
        random numbers come from a ``torch.Generator`` seeded with ``seed``,
        or from ``draws(gen) → GenDraws``."""
        space = self.space
        meta = _space_meta(space, fix_input)
        X0 = space.sobol_sample_opt(self.pop, seed=seed)
        if initial_suggest is not None:
            k = min(len(initial_suggest), self.pop)
            X0[:k] = np.asarray(initial_suggest)[:k]
        for name, val in (fix_input or {}).items():
            p = space.params[name]
            c0 = space._col_of[name]
            tv = np.asarray(p.transform(np.asarray([val]))).ravel()
            X0[:, c0 : c0 + p.num_cols] = tv[None, :]
        dev = torch.device(getattr(model, "device", "cuda"))
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        acq, pr = self.acq, acq_params if acq_params is not None else AcqParams()
        state = model.state if model is not None else None
        with torch.no_grad():
            Xf, Ff = evolve_raw(torch.as_tensor(np.asarray(X0, np.float32), device=dev),
                                lambda X: acq.eval_pure(model, state, pr, X), meta,
                                n_gens=self.iters, generator=gen, draws=draws)
        Xf, Ff = Xf.cpu().numpy(), Ff.cpu().numpy()
        if return_pop:
            return space.round_opt(Xf), Ff
        best = int(np.argmin(Ff[:, 0]))
        return space.round_opt(Xf[best : best + 1])
