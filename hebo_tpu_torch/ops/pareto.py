"""Multi-objective building blocks over a (P, M) objective tensor.

Port of ``hebo_tpu/ops/pareto.py`` (:29-141), minimization.  Every sort is
stable, as JAX's are: ``torch.argsort(stable=True)``, with the lexsort of
pareto.py:110 built from two stable sorts.  The per-front min/max
(``segment_min``/``segment_max``, :98-105) are masked ``amax``/``amin``
over each point's front, which propagate NaN on every device (CUDA's
``scatter_reduce`` does not promise to).  The crowding sum runs over the
objectives in order.

``pareto_mask`` (:144) and ``hypervolume_mc`` (:156), which GeneralBO's
EHVI selection uses, are plain PyTorch on every device.

On the card, rank and crowding come from kernel K5 (``csrc/pareto.cu``),
which peels every front on the device as the JAX ``while_loop`` does
(:55-77), with no host sync; ``nsga2_select`` takes from the same call the
NSGA-II key (``nsga2_key``, :130-141) and the survivors' order (a stable
argsort of the key), so an NSGA-II generation sorts nothing.  K5 has two
routes, chosen by shape (``route``): one CTA with everything in shared
memory (``nsga2_rank_crowd``, one launch) where it fits (``fits``: up to
~1,250 rows at M ≥ 2, 4,096 at M = 1), and a grid route past it, up to
``GRID_MAX_ROWS`` rows (``_launch_grid``: the domination bitset in device
memory, a peel by dominator counts, counting passes over a grid; a fixed
4-6 launches, scratch from the caching allocator, counted in
``nsga2_rank_crowd.grid_launches``), so NSGA-II's
survival at 2·pop rows runs on the card at any pop up to 16,384.  On the
CPU the plain version peels with a host test made once every
``_PEEL_CHUNK`` peels (extra peels past the last front change nothing).
"""

from __future__ import annotations

import functools

import torch

from . import native

__all__ = ["domination_matrix", "nondominated_rank", "crowding_distance", "nsga2_key",
           "nsga2_rank_crowd", "nsga2_rank_crowd_plain", "nsga2_select", "nsga2_select_plain",
           "fits", "route", "GRID_MAX_ROWS", "pareto_mask", "hypervolume_mc"]

_PEEL_CHUNK = 4
GRID_MAX_ROWS = 32768  # the grid route's limit (csrc/pareto.cu kGridNMax)


def domination_matrix(F: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """``D[i, j]`` iff point i dominates point j; invalid rows dominate
    nothing and are dominated by every valid row."""
    le = (F[:, None, :] <= F[None, :, :]).all(-1)
    lt = (F[:, None, :] < F[None, :, :]).any(-1)
    D = le & lt
    if valid is not None:
        D = D & valid[:, None]
        D = D | ((~valid)[None, :] & valid[:, None])
        D = D & ~((~valid)[:, None] & (~valid)[None, :])
    return D


def nondominated_rank(F: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """Front index per point (0 = Pareto front) by iterative peeling
    (kernel K5 on CUDA)."""
    if F.device.type != "cpu":
        return nsga2_rank_crowd(F, valid)[0]
    return _rank_plain(F, valid)


def _rank_plain(F: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    P = F.shape[0]
    D = domination_matrix(F, valid)
    Di = D.to(torch.int32)
    n_dom = Di.sum(0)
    rank = torch.full((P,), P, dtype=torch.int32, device=F.device)
    assigned = torch.zeros(P, dtype=torch.bool, device=F.device)
    i = 0
    while i < P:
        for _ in range(min(_PEEL_CHUNK, P - i)):
            front = (n_dom == 0) & ~assigned
            rank = torch.where(front, i, rank)
            assigned = assigned | front
            removed = (Di * front[:, None]).sum(0)
            n_dom = torch.where(assigned, n_dom, n_dom - removed)
            i += 1
        if bool(assigned.all()):
            break
    return rank


def _stable_lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Order by ``primary``, ties by ``secondary`` (``jnp.lexsort((secondary,
    primary))``)."""
    o1 = torch.argsort(secondary, stable=True)
    return o1[torch.argsort(primary[o1], stable=True)]


def crowding_distance(F: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """NSGA-II crowding distance within each front (pymoo semantics: front
    boundaries +inf, interior gaps over the front's own span, mean over
    objectives)."""
    P, M = F.shape
    big = 1e30
    same = (rank[:, None] == rank[None, :])[..., None]  # (P, P, 1): k in j's front
    inf = torch.tensor(float("inf"), dtype=F.dtype, device=F.device)
    f_max = torch.where(same, F[None], -inf).amax(1)  # (P, M), per point's front
    f_min = torch.where(same, F[None], inf).amin(1)
    span = torch.clamp(f_max - f_min, min=1e-12)
    dists = []
    for m in range(M):
        f = F[:, m]
        order = _stable_lexsort(rank, f)
        f_s = f[order]
        r_s = rank[order]
        same = r_s[1:] == r_s[:-1]
        false = torch.zeros(1, dtype=torch.bool, device=F.device)
        prev_same = torch.cat([false, same])
        next_same = torch.cat([same, false])
        f_prev = torch.cat([f_s[:1], f_s[:-1]])
        f_next = torch.cat([f_s[1:], f_s[-1:]])
        d = torch.where(prev_same & next_same,
                        (f_next - f_prev) / span[order, m],
                        torch.full_like(f_s, big))
        dists.append(torch.empty_like(d).scatter_(0, order, d))
    dists = torch.stack(dists, 1)
    clamped = torch.clamp(dists, max=big)
    d = clamped[:, 0]
    for m in range(1, M):
        d = d + clamped[:, m]
    # a tensor divisor: CUDA turns division by a Python number into a
    # multiplication by its reciprocal, which rounds differently
    d = d / torch.full_like(d, M)
    return torch.where((dists >= big).any(1), torch.full_like(d, float("inf")), d)


def nsga2_rank_crowd_plain(F: torch.Tensor, valid: torch.Tensor | None = None):
    """Plain version of kernel K5: the peeled rank and the crowding."""
    rank = _rank_plain(F, valid)
    return rank, crowding_distance(F, rank)


def nsga2_rank_crowd(F: torch.Tensor, valid: torch.Tensor | None = None):
    """(rank (P,) int32, crowding (P,) float32) of F (P, M): kernel K5 on a
    CUDA tensor (its route by ``route``); ``nondominated_rank`` and
    ``crowding_distance`` on a CPU tensor.  ``valid`` (P,) bool marks the
    rows that take part."""
    if F.device.type == "cpu":
        return nsga2_rank_crowd_plain(F, valid)
    return _launch(F, valid, None, False)[:2]


def nsga2_select_plain(F: torch.Tensor, n_keep: int | None = None,
                       valid: torch.Tensor | None = None):
    """Plain version of ``nsga2_select``."""
    rank, crowd = nsga2_rank_crowd_plain(F, valid)
    key = nsga2_key(rank, crowd)
    order = None if n_keep is None else torch.argsort(key, stable=True)[:n_keep]
    return rank, crowd, key, order


def nsga2_select(F: torch.Tensor, n_keep: int | None = None, valid: torch.Tensor | None = None):
    """(rank (P,) int32, crowding (P,) float32, NSGA-II key (P,) float32,
    order (n_keep,) int64 or None) of F (P, M): the key is ``nsga2_key`` of
    the rank and crowding, the order ``torch.argsort(key, stable=True)``'s
    first ``n_keep`` (None without ``n_keep``).  Kernel K5 on a CUDA
    tensor, no sort and no host read; the plain version on a CPU tensor."""
    if F.device.type == "cpu":
        return nsga2_select_plain(F, n_keep, valid)
    return _launch(F, valid, n_keep, True)


@functools.lru_cache(maxsize=None)
def fits(P: int, M: int) -> bool:
    """Whether K5's one-CTA route takes F (P, M): its shared memory fits one
    CTA and its keys stay exact in float32 (``csrc/pareto.cu::hebo_nsga2_fits``;
    builds the kernel)."""
    return bool(native.load("pareto").hebo_nsga2_fits(P, M))


@functools.lru_cache(maxsize=None)
def route(P: int, M: int) -> str | None:
    """K5's route for F (P, M): "cta" where ``fits``, "grid" past it up to
    ``GRID_MAX_ROWS`` rows, None beyond (``csrc/pareto.cu::hebo_nsga2_route``;
    builds the kernel)."""
    return {0: "cta", 1: "grid"}.get(native.load("pareto").hebo_nsga2_route(P, M))


@functools.lru_cache(maxsize=None)
def _grid_scratch_bytes(P: int, M: int) -> int:
    return native.load("pareto").hebo_nsga2_grid_scratch(P, M)


def _launch(F, valid, n_keep, with_key):
    native.require_cuda("nsga2_rank_crowd", F)
    if F.dim() != 2:
        raise ValueError(f"nsga2_rank_crowd: expected F (P, M), got {tuple(F.shape)}")
    P, M = F.shape
    if P > GRID_MAX_ROWS or M < 1:
        raise ValueError(f"nsga2_rank_crowd: P = {P}, M = {M}: K5 takes at most {GRID_MAX_ROWS} "
                         "rows and at least one objective")
    how = route(P, M)
    if valid is not None:
        if valid.device != F.device or valid.dtype != torch.bool or valid.shape != (P,):
            raise ValueError("nsga2_rank_crowd: valid must be a (P,) bool tensor on F's device")
        valid = valid.contiguous()
    dev = F.device
    rank = torch.empty(P, dtype=torch.int32, device=dev)
    crowd = torch.empty(P, dtype=torch.float32, device=dev)
    key = torch.empty(P, dtype=torch.float32, device=dev) if with_key else None
    order = None
    if with_key and n_keep is not None:
        order = torch.empty(min(n_keep, P), dtype=torch.int64, device=dev)
    args = (F.data_ptr(), None if valid is None else valid.data_ptr(), rank.data_ptr(),
            crowd.data_ptr(), None if key is None else key.data_ptr(),
            None if order is None else order.data_ptr(), 0 if order is None else order.numel())
    if how == "cta":
        native.check(native.call(native.load("pareto").hebo_nsga2_rank_crowd, dev, *args, P, M),
                     "nsga2_rank_crowd")
    else:
        _launch_grid(args, P, M, dev)
        nsga2_rank_crowd.grid_launches += 1
    nsga2_rank_crowd.launches += 1
    return rank, crowd, key, order


def _launch_grid(args, P: int, M: int, dev) -> None:
    """K5's grid route (``csrc/pareto.cu::hebo_nsga2_rank_crowd_grid``) on
    ``_launch``'s pointers, its scratch from the caching allocator."""
    scratch = torch.empty(_grid_scratch_bytes(P, M), dtype=torch.uint8, device=dev)
    err = native.call(native.load("pareto").hebo_nsga2_rank_crowd_grid, dev, *args,
                      scratch.data_ptr(), P, M)
    native.check(err, "nsga2_rank_crowd (grid route)")


nsga2_rank_crowd.launches = 0
# the launches that took the grid route (each also counted in ``launches``)
nsga2_rank_crowd.grid_launches = 0


def nsga2_key(rank: torch.Tensor, crowd: torch.Tensor) -> torch.Tensor:
    """Scalar sort key: ascending rank, then descending crowding (exact, via
    the ordinal position of the crowding value).  Plain on every device:
    on the card ``nsga2_select`` takes it from K5's launch."""
    P = rank.shape[0]
    c = torch.where(torch.isnan(crowd), torch.full_like(crowd, -float("inf")), crowd)
    crowd_ord = torch.argsort(torch.argsort(-c, stable=True), stable=True)
    return rank.to(torch.float32) * P + crowd_ord.to(torch.float32)


def pareto_mask(F: torch.Tensor, valid: torch.Tensor | None = None) -> torch.Tensor:
    """(P,) bool: the nondominated (Pareto-optimal) rows of F (P, M)."""
    mask = ~domination_matrix(F, valid).any(0)
    return mask if valid is None else mask & valid


def hypervolume_mc(F: torch.Tensor, ref_point: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo hypervolume of the region that F (..., R, M) dominates
    below ``ref_point`` (M,): the share of the uniform points u (n, M),
    mapped into the box [min F, ref], that some row of F dominates, times
    the box's volume.  The leading axes are a batch of point sets on the
    same uniforms (GeneralBO scores every candidate set of a greedy round
    in one call, the JAX package's ``vmap``)."""
    lo = F.amin(-2)  # (..., M)
    pts = lo[..., None, :] + u * (ref_point - lo)[..., None, :]  # (..., n, M)
    dominated = (F[..., None, :, :] <= pts[..., :, None, :]).all(-1).any(-1)  # (..., n)
    vol_box = torch.prod(ref_point - lo, -1)
    return dominated.to(F.dtype).mean(-1) * vol_box
