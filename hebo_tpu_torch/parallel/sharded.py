"""Multi-device SPMD over ``torch.distributed``: the device mesh, its
collectives, best-chain selection and island NSGA-II (port of
``hebo_tpu/parallel/sharded.py``).

The JAX package runs ``shard_map`` over a 1-D ``Mesh(('pop',))``.  Here
the same program is SPMD over processes, one per card: every rank runs the
same host code with the same seeds, and only the device work differs by
rank.  A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` with
one named axis (``make_mesh``); its collectives are those of the axis's
process group (NCCL on CUDA, gloo on the CPU):

* ``lax.all_gather(x, axis, tiled=True)`` → ``all_gather`` (concatenated
  along the leading axis, rank-major);
* ``lax.psum`` / ``pmin`` / ``pmax`` → ``all_reduce``;
* ``fold_in(key, axis_index)`` → ``rank_generator(seed, mesh)``, a
  ``torch.Generator`` seeded from (seed, rank).

Every helper takes ``mesh=None`` as a world of one (no collective), so a
function written once serves both the unsharded and the sharded front end.

What runs on the mesh:

* ``HEBO(mesh=...)`` (``optimizers/hebo.py::HEBO._sharded_program``, the
  port of ``make_fused_suggest_sharded`` :153-278): ``n_restarts`` chains
  per rank, the first argmin over every rank's losses (``select_chain``),
  and ``island_evolve``: each rank evolves its island of ``pop / world``
  points with NSGA-II + MACE, and every ``migrate_every`` generations each
  island's elite is all-gathered and replaces that island's worst points;
* ``sharded_suggest_step`` (``make_sharded_suggest_step`` :56-134): one
  chain per rank, the best selected by ``_tree_select_best``;
* ``ops/block_chol.py``: the row-slab Cholesky of the GP above
  ``max_cholesky_size``;
* ``models/gp/inference.py``: HMC chains and SMC particles over the ranks;
* ``meta/ppo.py``: data-parallel PPO.

This module imports only torch at load time (the model code imports it).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "mesh_size", "mesh_rank", "all_gather", "all_reduce", "rank_generator",
           "select_chain", "island_evolve", "sharded_suggest_step"]


def make_mesh(n_devices: Optional[int] = None, axis: str = "pop", device="cuda"):
    """A 1-D ``DeviceMesh`` over every rank of the initialized default
    process group, its one axis named ``axis``.  Rank r works on
    ``cuda:{local_rank}`` (``LOCAL_RANK``, as ``torchrun`` sets it, else
    r modulo the cards of the host), which becomes the current device; the
    group must be NCCL there and gloo for ``device="cpu"``.  Raises when no
    process group is initialized: the caller initializes it (its address,
    world size and rank), never this function.  ``n_devices``, when given,
    must equal the world size."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group; call torch.distributed.init_process_group "
                           "(address, world size, rank) first")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh: n_devices={n_devices}, but the process group has {world} ranks")
    dev = torch.device(device)
    backend = str(dist.get_backend())
    if dev.type == "cuda":
        from ..utils.device import resolve_device

        resolve_device("cuda")  # raises without CUDA; float32 matmuls without TF32
        if "nccl" not in backend:
            raise RuntimeError(f"make_mesh: device 'cuda' needs an NCCL process group, got {backend!r}")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    elif dev.type == "cpu":
        if "gloo" not in backend:
            raise RuntimeError(f"make_mesh: device 'cpu' needs a gloo process group, got {backend!r}")
    else:
        raise ValueError(f"make_mesh: unsupported device {device!r}: use 'cuda' or 'cpu'")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis,))


# ------------------------------------------------------------ collectives
def _group(mesh):
    return mesh.get_group(mesh.mesh_dim_names[0])


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def mesh_rank(mesh) -> int:
    return 0 if mesh is None else mesh.get_local_rank()


# the tensor all-gather: its newer name where the installed torch has it
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the leading axis, rank-major
    (``lax.all_gather(t, axis, tiled=True)``); a 0-d ``t`` gives (world,)."""
    if mesh is None:
        return t if t.dim() else t.reshape(1)
    t = t.reshape(1) if t.dim() == 0 else t.contiguous()
    out = t.new_empty((mesh.size() * t.shape[0],) + tuple(t.shape[1:]))
    _gather_into(out, t, group=_group(mesh))
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, mesh, op: str = "sum") -> torch.Tensor:
    """``psum`` / ``pmin`` / ``pmax`` of ``t`` over the ranks, as a new
    tensor (``t`` is not changed)."""
    if mesh is None:
        return t
    out = t.clone()
    dist.all_reduce(out, op=_OPS[op], group=_group(mesh))
    return out


def rank_generator(seed: int, mesh, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, rank): the stream of
    this rank's own draws (``fold_in(key, axis_index)`` in the JAX
    package)."""
    s = int(np.random.SeedSequence([int(seed), mesh_rank(mesh)]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


# ------------------------------------------------------- chain selection
def _pack(leaves):
    return torch.cat([t.reshape(-1) for t in leaves])


def _unpack(flat, like):
    out, i = [], 0
    for t in like:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out


def _tree_select_best(tree, loss: torch.Tensor, mesh):
    """The tree of the rank with the least ``loss`` (one chain per rank:
    leaves lead with 1, ``loss`` (1,)), on every rank
    (sharded.py:48-53): ``pmin`` of the loss, then every rank's tree
    weighted by its share of the tie and summed, so ranks that tie are
    averaged.  One all-reduce carries the whole tree."""
    from ..models.gp.tree import tree_leaves, tree_unflatten

    best = all_reduce(loss, mesh, "min")
    w = (loss == best).to(loss.dtype)
    w = w / all_reduce(w, mesh, "sum")
    leaves = tree_leaves(tree)
    flat = _pack([t * w.reshape((-1,) + (1,) * (t.dim() - 1)) for t in leaves])
    return tree_unflatten(tree, _unpack(all_reduce(flat, mesh, "sum"), leaves))


def select_chain(trees, loss: torch.Tensor, mesh, dims):
    """The first argmin over every rank's chains (sharded.py:251-262:
    ``jnp.argmin`` of the gathered losses, chain r·R + i at rank r): the
    losses ``loss`` (R,) are all-gathered, and each tree of ``trees`` is
    cut to the best chain on every rank.  ``dims`` names each tree's chain
    axis (0 for the final params (R, ...), 1 for the samples (S, R, ...));
    the chain axis is kept with size 1 where it leads, and dropped
    elsewhere.  The rank that holds the chain contributes it, the others
    zeros (a ``where``, so another chain's NaNs never reach it), through
    one all-reduce; no value is read on the host."""
    from ..models.gp.tree import tree_leaves, tree_unflatten

    R = loss.shape[0]
    best = torch.argmin(all_gather(loss, mesh))
    own = torch.arange(R, device=loss.device) + mesh_rank(mesh) * R == best
    picked = []
    for tree, d in zip(trees, dims):
        for t in tree_leaves(tree):
            m = own.reshape((1,) * d + (R,) + (1,) * (t.dim() - d - 1))
            s = torch.where(m, t, torch.zeros_like(t)).sum(d)
            picked.append(s.unsqueeze(0) if d == 0 else s)
    flat = _unpack(all_reduce(_pack(picked), mesh, "sum"), picked)
    out, i = [], 0
    for tree in trees:
        n = len(tree_leaves(tree))
        out.append(tree_unflatten(tree, flat[i:i + n]))
        i += n
    return out


# ----------------------------------------------------------------- islands
def island_evolve(init_local: torch.Tensor, eval_fn: Callable, mt, iters: int, migrate_every: int,
                  mesh, generator: Optional[torch.Generator] = None,
                  draws: Optional[Callable] = None):
    """NSGA-II on this rank's island with elite migration
    (sharded.py:191-225): ``max(1, iters // migrate_every)`` rounds of
    ``migrate_every`` generations (``acq_optimizers/evolution.evolve_raw``);
    after each round but the last, every island's best point (first
    argmin of the first objective) is all-gathered, and the
    ``min(world, pop_local)`` worst points of the island (descending first
    objective, ties in index order) are replaced by the gathered elites, its
    own included.  ``draws(round, generation) → GenDraws`` replaces the
    generator's draws.  Returns the island's final (X, F)."""
    from ..acq_optimizers.evolution import evolve_raw

    X, F = init_local, None
    n_rounds = max(1, iters // migrate_every)
    for r in range(n_rounds):
        X, F = evolve_raw(X, eval_fn, None, n_gens=migrate_every, generator=generator,
                          draws=None if draws is None else (lambda g, r=r: draws(r, g)), mt=mt)
        if r < n_rounds - 1:
            elites = all_gather(X.index_select(0, torch.argmin(F[:, 0]).reshape(1)), mesh)
            k = min(elites.shape[0], X.shape[0])
            worst = torch.argsort(-F[:, 0], stable=True)[:k]
            X = X.index_copy(0, worst, elites[:k])
    return X, F


def sharded_suggest_step(mesh, model, acq, meta, data, acq_params, init_pop_local: torch.Tensor, *,
                         n_gens: int = 16, migrate_every: int = 4,
                         generator: Optional[torch.Generator] = None):
    """One SPMD suggest step (``make_sharded_suggest_step``, sharded.py:56-134):
    each rank fits one chain of ``model.core`` (``GPCore.fit_from``, the
    generator's draws), the best chain's parameters reach every rank
    through ``_tree_select_best``, its posterior cache is built, and each
    rank evolves its island ``init_pop_local`` (``pop_per_device`` points)
    under ``acq`` for ``n_gens`` generations with elite migration.
    ``generator`` is this rank's (``rank_generator``).  Returns the gathered
    population (world · pop_per_device, D), its objectives and the best
    parameters (leading axis 1)."""
    from ..acq_optimizers.evolution import meta_tensors

    core = model.core
    p0 = core.init_params(data, 1, generator)
    pf, loss, _ = core.fit_from(p0, data, generator)
    best = _tree_select_best(pf, loss, mesh)
    state = (best, core.posterior_cache_batched(best, data), data)
    with torch.no_grad():
        X, F = island_evolve(init_pop_local, lambda Xc: acq.eval_pure(model, state, acq_params, Xc),
                             meta_tensors(meta, init_pop_local.device), n_gens, migrate_every, mesh,
                             generator=generator)
    return all_gather(X, mesh), all_gather(F, mesh), best
