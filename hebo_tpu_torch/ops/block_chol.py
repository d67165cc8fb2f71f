"""Block-sharded Cholesky across the device mesh (port of
``hebo_tpu/ops/block_chol.py``).

The kernel matrix is cut into row slabs, one per rank (N / world rows),
and the right-looking blocked factorization walks its ``block``-wide
columns (block_chol.py:37-88).  At each step j:

1. the slabs' block column j is all-gathered (N × block floats, the only
   communication of the factorization);
2. every rank factors the diagonal block Ajj itself: kernel K1a
   (``chol_factor``) at (1, block) gives Ljj and its 64-wide diagonal-tile
   inverses, and Wjj = Ljj⁻¹ comes from them (the tile inverse itself for a
   block of at most one tile, kernel K1b (``chol_winv``) above);
3. the panel below the diagonal block is col · Wjjᵀ (the JAX package's
   ``triangular_solve(Ljj, col, transpose_a=True)``), and the rank's slab
   takes its rows of the panel and subtracts its rank-block trailing update.

The products run in full float32 (no TF32), where the JAX package runs
them at ``Precision.HIGHEST``.  The JAX package's trailing update spans the
full width, masked, for static shapes; here it spans only the columns right
of the block, the only ones it changes below the diagonal, since nothing is
traced.

The solve and the GP's ladder gather L on every rank and make W = L⁻¹ by
K1b at the full (1, N): K1b takes L and its 64-wide diagonal-tile inverses,
which come from the blocks' own (a block that is a multiple of 64 holds
whole tiles), or, for a block that is not, from the block inverses by the
block formula [[W₁, 0], [−W₂ L₂₁ W₁, W₂]] over the blocks a tile spans.
``block_chol_solve_sharded``'s two triangular solves (block_chol.py:155-161)
are the products Wᵀ(W B).  No library Cholesky or triangular solve runs on
a CUDA tensor.

``block_ladder_factor`` is the GP's 2-rung jitter ladder on this route
(gp.py:673-705): factor at 1e-6, and only when the factor has a NaN on some
rank again at 1e-6 + 1e-3 · mean diagonal.  It runs eagerly, and reads one
all-reduced finiteness flag on the host per rung, so every rank takes the
same branch.
"""

from __future__ import annotations

import warnings

import torch

from ..parallel.sharded import all_gather, all_reduce, mesh_rank, mesh_size
from .chol_kernel import TILE, chol_factor, chol_winv, padded_size

__all__ = ["block_cholesky_sharded", "block_chol_solve_sharded", "block_ladder_factor"]


def _effective_block(N: int, world: int, block: int) -> int:
    if N % world:
        raise ValueError(f"block_cholesky_sharded: N = {N} is not a multiple of the mesh size {world}")
    if block > N // world:
        # a block wider than one slab cannot be panel-solved locally:
        # shrink it, and say so (the work / communication balance changes)
        warnings.warn(f"block_cholesky_sharded: block={block} > slab rows {N // world}; "
                      f"using effective block={N // world}", stacklevel=3)
        block = N // world
    if N % block:
        raise ValueError(f"block_cholesky_sharded: N = {N} is not a multiple of block {block}")
    return block


def _no_tf32(K: torch.Tensor) -> None:
    if K.device.type == "cuda":
        from ..utils.device import resolve_device

        resolve_device(K.device)


def _factor_slab(K: torch.Tensor, jitter, mesh, block: int):
    """This rank's row slab of L (rows, N), the diagonal-block inverses
    Wjj (n_blocks, block, block) and the blocks' K1a tile inverses
    (n_blocks, ⌈block / 64⌉, 64, 64), for the full K (N, N) of every rank
    plus ``jitter`` on the diagonal."""
    N = K.shape[-1]
    world, rank = mesh_size(mesh), mesh_rank(mesh)
    rows = N // world
    r0 = rank * rows
    A = K[r0:r0 + rows].clone()
    ar = torch.arange(rows, device=K.device)
    A[ar, r0 + ar] += jitter
    L = torch.zeros_like(A)
    Wb, Wd_b = [], []
    for j in range(N // block):
        c0, c1 = j * block, (j + 1) * block
        col = all_gather(A[:, c0:c1], mesh)  # (N, block)
        Lp, Wd = chol_factor(col[c0:c1][None].contiguous())
        Wjj = (Wd[0, 0, :block, :block] if block <= TILE else chol_winv(Lp, Wd)[0, :block, :block])
        Wb.append(Wjj)
        Wd_b.append(Wd[0])
        P = col[c1:] @ Wjj.transpose(0, 1)  # the panel's rows below the diagonal block
        lo, hi = max(r0, c0), min(r0 + rows, c1)  # this slab's rows of the diagonal block
        if lo < hi:
            L[lo - r0:hi - r0, c0:c1] = Lp[0, lo - c0:hi - c0, :block]
        lo = max(r0, c1)
        if lo < r0 + rows:
            P_loc = P[lo - c1:r0 + rows - c1]
            L[lo - r0:, c0:c1] = P_loc
            A[lo - r0:, c1:] -= P_loc @ P.transpose(0, 1)
    return L, torch.stack(Wb), torch.stack(Wd_b)


def block_cholesky_sharded(K: torch.Tensor, mesh, *, block: int = 128,
                           jitter: float = 1e-6) -> torch.Tensor:
    """This rank's row slab (N / world, N) of the lower L with L Lᵀ = K +
    jitter·I (block_chol.py:91-136); K (N, N) is the full matrix on every
    rank, N a multiple of the mesh size and of ``block`` (shrunk, with a
    warning, to the slab height when it is wider).  A non-PSD K gives NaNs."""
    _no_tf32(K)
    block = _effective_block(K.shape[-1], mesh_size(mesh), block)
    return _factor_slab(K, jitter, mesh, block)[0]


def _tile_inverses(L: torch.Tensor, Wb: torch.Tensor, block: int) -> torch.Tensor:
    """(Np / 64, 64, 64) inverses of the 64-wide diagonal tiles of the
    gathered L (N, N), from the diagonal-block inverses Wb: a tile's
    segment inside one block has the matching diagonal sub-block of that
    block's inverse (a diagonal sub-block of a lower-triangular inverse is
    the inverse of the sub-block), and the tile's rows below are
    W_i< = −W_ii L_i< W_<< (for two segments [[W₁, 0], [−W₂ L₂₁ W₁, W₂]])."""
    N = L.shape[-1]
    Np = padded_size(N)
    tiles = []
    for t in range(Np // TILE):
        a, b = t * TILE, min((t + 1) * TILE, N)
        Wt = torch.eye(TILE, dtype=L.dtype, device=L.device)
        s = a
        while s < b:
            j = s // block
            e = min(b, (j + 1) * block)
            o = s - j * block
            Wi = Wb[j, o:o + e - s, o:o + e - s]
            Wt[s - a:e - a, s - a:e - a] = Wi
            if s > a:
                Wt[s - a:e - a, :s - a] = -Wi @ (L[s:e, a:s] @ Wt[:s - a, :s - a])
            s = e
        tiles.append(Wt)
    return torch.stack(tiles)


def _finish(L_loc, Wb, Wd_b, mesh, block: int):
    """Gather L, and W = L⁻¹ by K1b at the full size."""
    L = all_gather(L_loc, mesh)
    N = L.shape[-1]
    Np = padded_size(N)
    Wd = Wd_b.reshape(-1, TILE, TILE) if block % TILE == 0 else _tile_inverses(L, Wb, block)
    Lp = L
    if Np != N:  # identity-padded to whole tiles, as K1 pads
        Lp = torch.eye(Np, dtype=L.dtype, device=L.device)
        Lp[:N, :N] = L
    W = chol_winv(Lp[None].contiguous(), Wd[None].contiguous())[0, :N, :N]
    return L, W


def block_chol_solve_sharded(K: torch.Tensor, B: torch.Tensor, mesh, *, block: int = 128,
                             jitter: float = 1e-6) -> torch.Tensor:
    """X with (K + jitter·I) X = B (block_chol.py:139-161): the factor and
    W = L⁻¹ gathered on every rank, then X = Wᵀ (W B)."""
    _no_tf32(K)
    block = _effective_block(K.shape[-1], mesh_size(mesh), block)
    _, W = _finish(*_factor_slab(K, jitter, mesh, block), mesh, block)
    return W.transpose(0, 1) @ (W @ B)


def block_ladder_factor(K: torch.Tensor, mesh, *, block: int = 128):
    """(L, W, ok) of K (N, N) on the mesh by the 2-rung ladder of the GP's
    mesh branch (gp.py:673-705): rung 1 at jitter 1e-6, rung 2 at 1e-6 +
    1e-3 · (mean diagonal, floored at 1e-12), the second run only when the
    first factor has a non-finite entry on some rank.  ``ok`` (a 0-d bool
    tensor) is False when both rungs fail; L and W are then non-finite.
    One host read of the all-reduced finiteness flag per rung (every rank
    takes the same branch; the route is eager)."""
    _no_tf32(K)
    block = _effective_block(K.shape[-1], mesh_size(mesh), block)
    scale = torch.clamp(torch.diagonal(K).mean(), min=1e-12)
    for jitter in (1e-6, 1e-6 + 1e-3 * scale):
        L_loc, Wb, Wd_b = _factor_slab(K, jitter, mesh, block)
        fin = all_reduce(torch.isfinite(L_loc).all().to(torch.int32).reshape(1), mesh, "min")
        if bool(fin.item()):
            L, W = _finish(L_loc, Wb, Wd_b, mesh, block)
            return L, W, torch.isfinite(L).all() & torch.isfinite(W).all()
    L = all_gather(L_loc, mesh)
    return L, torch.full_like(L, float("nan")), torch.zeros((), dtype=torch.bool, device=K.device)
