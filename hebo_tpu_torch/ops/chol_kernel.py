"""Kernel K1: batched Cholesky with W = L⁻¹ (``csrc/chol.cu``).

Replaces ``hebo_tpu/ops/pallas_chol.py::chol_inv_slab`` (:684), whose two
``pallas_call``s become two wrappers:

* ``chol_factor`` (K1a, for ``_factor_slab_kernel``, pallas_call :613):
  K (B, n, n) → L (B, Np, Np) and the diagonal-tile inverses
  Wd (B, Np/64, 64, 64), where Np pads n to a multiple of 64 with an
  identity block;
* ``chol_winv`` (K1b, for ``_winv_tile_kernel``, pallas_call :665):
  (L, Wd) → W = L⁻¹ (B, Np, Np);

and ``chol_inv(K) → (L, W)`` slices both back to (B, n, n).  Any n works;
the padding is exact, as ``_run_slab`` pads the batch with identities
(pallas_chol.py:600-604).

``cholesky_batched`` and ``chol_inv_batched`` are the API of the JAX
package's r3 VMEM-resident kernel ``_chol_kernel`` (pallas_call :228,
``cholesky_batched`` :243 and ``chol_inv_batched`` :249, N ≤ 1024): the
same L, or (L, W), computed here by K1 at any N.

The jitter ladder's arguments: ``jitter`` (B,) is added to K's diagonal
inside K1a, and ``skip`` (B,) int32 leaves a flagged matrix's L, Wd and W
as they are in the ``out`` buffers of an earlier call, so that a rung runs
on the device for the matrices that still need it, with no host test.

Failure semantics: a non-PSD matrix yields NaNs in its own L and W and in
no other matrix of the batch.  The plain version gets there by NaN-filling
the matrices whose ``cholesky_ex`` ``info`` is non-zero, because
``cholesky_ex`` itself returns a finite, wrong factor for them.

K1a takes one of two routes on the card (``route``; the rule is
``csrc/chol.cu::pick_route``): "step", a launch per 64-wide panel, below 8
tiles (N ≤ 448), and "flow", one persistent left-looking launch that forms
each panel tile once, from 8 tiles (HEBO's buckets from 512, BOCS's
(1, 5051)), at any batch.  Both compute the same function; their sums run
in other orders.

``_schedule_plain`` mirrors, in plain PyTorch, the block schedule that the
CUDA kernels run (16-wide sub-blocked tile factor; K1a's look-ahead panel
steps or its left-looking tasks; doubling levels of W); only the CPU tests
call it.
"""

from __future__ import annotations

import functools

import torch

from . import native

__all__ = [
    "TILE", "ROUTES", "padded_size", "route", "chol_factor", "chol_factor_plain", "chol_winv",
    "chol_winv_plain", "chol_inv", "cholesky_batched", "chol_inv_batched",
]

TILE = 64
SUB = 16  # sub-block edge of the CUDA tile factor
ROUTES = ("step", "flow")  # K1a's routes, by the number csrc/chol.cu gives them


def padded_size(n: int) -> int:
    return max(TILE, -(-n // TILE) * TILE)


@functools.lru_cache(maxsize=None)
def _route_code(Np: int) -> int:
    # the rule reads the padded size alone, so one library call per size
    return native.load("chol").hebo_chol_route(Np)


def route(n: int) -> str:
    """The route K1a takes on the card for matrices of size n (any batch),
    as ``csrc/chol.cu::pick_route`` decides it."""
    return ROUTES[_route_code(padded_size(int(n)))]


def _pad_identity(K: torch.Tensor, Np: int) -> torch.Tensor:
    B, n, _ = K.shape
    if Np == n:
        return K
    Kp = torch.eye(Np, dtype=K.dtype, device=K.device).repeat(B, 1, 1)
    Kp[:, :n, :n] = K
    return Kp


def _skip_args(what, B, Np, skip, out, shapes):
    if skip is not None and out is None:
        raise ValueError(f"{what}: skip needs the out buffers whose skipped matrices it keeps")
    if out is not None and tuple(tuple(t.shape) for t in out) != shapes:
        raise ValueError(f"{what}: out shapes {[tuple(t.shape) for t in out]}, expected {list(shapes)}")
    if skip is not None and (skip.shape != (B,) or skip.dtype != torch.int32):
        raise ValueError(f"{what}: skip must be a (B,) int32 tensor")


def _merge_plain(new, skip, out):
    """Write ``new`` into ``out`` where ``skip`` is 0 (plain versions)."""
    if out is None:
        return new
    keep = skip.bool() if skip is not None else torch.zeros(new[0].shape[0], dtype=torch.bool)
    for o, t in zip(out, new):
        o.copy_(torch.where(keep.reshape((-1,) + (1,) * (t.dim() - 1)).to(o.device), o, t))
    return out


def chol_factor_plain(K: torch.Tensor, jitter=None, skip=None, out=None):
    """Plain version of K1a: (L, Wd) of the identity-padded batch
    K + diag(jitter), written into ``out`` except where ``skip`` is set."""
    B, n, _ = K.shape
    Np = padded_size(n)
    _skip_args("chol_factor", B, Np, skip, out, ((B, Np, Np), (B, Np // TILE, TILE, TILE)))
    if skip is not None and K.device.type == "cpu" and bool(skip.all()):
        return out  # nothing to factor (a host read: the CPU only)
    if jitter is not None:
        K = K + jitter[:, None, None] * torch.eye(n, dtype=K.dtype, device=K.device)
    L, info = torch.linalg.cholesky_ex(_pad_identity(K, Np))
    L = torch.where((info != 0)[:, None, None], torch.full_like(L, float("nan")), L)
    nt = Np // TILE
    Ld = torch.stack(
        [L[:, t * TILE:(t + 1) * TILE, t * TILE:(t + 1) * TILE] for t in range(nt)], 1
    )
    eye = torch.eye(TILE, dtype=K.dtype, device=K.device).expand_as(Ld)
    Wd = torch.linalg.solve_triangular(Ld, eye, upper=False)
    return _merge_plain((L, Wd), skip, out)


def chol_winv_plain(L: torch.Tensor, Wd: torch.Tensor, skip=None, out=None) -> torch.Tensor:
    """Plain version of K1b: W = L⁻¹ (``Wd`` is implied by ``L``), written
    into ``out`` except where ``skip`` is set."""
    B, Np, _ = L.shape
    _skip_args("chol_winv", B, Np, skip, None if out is None else (out,), ((B, Np, Np),))
    if skip is not None and L.device.type == "cpu" and bool(skip.all()):
        return out
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    W = torch.linalg.solve_triangular(L, eye, upper=False)
    return _merge_plain((W,), skip, None if out is None else (out,))[0]


def _ptr(t):
    return None if t is None else t.data_ptr()


def chol_factor(K: torch.Tensor, jitter=None, skip=None, out=None, route=None):
    """K1a: (L, Wd) for K (B, n, n) float32 plus ``jitter`` (B,) on its
    diagonal; kernel on CUDA, plain on CPU.  With ``out`` = (L, Wd) the
    result goes there, and matrices whose ``skip`` (B,) int32 flag is set
    keep what ``out`` holds.  ``route`` ("step" or "flow") forces K1a's
    route on the card; None takes the size's (``route(n)``)."""
    if route is not None and route not in ROUTES:
        raise ValueError(f"chol_factor: route {route!r}, expected one of {ROUTES}")
    if K.device.type == "cpu":
        return chol_factor_plain(K, jitter, skip, out)
    native.require_cuda("chol_factor", K)
    B, n, n2 = K.shape
    if n != n2:
        raise ValueError(f"chol_factor: expected square matrices, got {tuple(K.shape)}")
    Np = padded_size(n)
    _skip_args("chol_factor", B, Np, skip, out, ((B, Np, Np), (B, Np // TILE, TILE, TILE)))
    if jitter is not None:
        native.require_cuda("chol_factor", K, jitter)
        if jitter.shape != (B,):
            raise ValueError(f"chol_factor: jitter {tuple(jitter.shape)}, expected {(B,)}")
    if skip is not None:
        native.require_cuda("chol_factor", skip, dtype=torch.int32)
    if out is None:
        L = torch.empty((B, Np, Np), dtype=torch.float32, device=K.device)
        Wd = torch.empty((B, Np // TILE, TILE, TILE), dtype=torch.float32, device=K.device)
    else:
        L, Wd = out
        native.require_cuda("chol_factor", K, L, Wd)
    lib = native.load("chol")
    r = _route_code(Np) if route is None else ROUTES.index(route)
    if ROUTES[r] == "flow":  # each matrix's counters: 2 per tile row and its ticket
        scratch = torch.empty(B * (2 * (Np // TILE) + 1), dtype=torch.int32, device=K.device)
    else:  # the trailing matrix
        scratch = torch.empty_like(L) if Np > TILE else L
    err = native.call(lib.hebo_chol_factor, K.device, K.data_ptr(), _ptr(jitter), _ptr(skip),
                      L.data_ptr(), Wd.data_ptr(), scratch.data_ptr(), r, B, n, Np)
    native.check(err, "chol_factor")
    chol_factor.launches += 1
    return L, Wd


def chol_winv(L: torch.Tensor, Wd: torch.Tensor, skip=None, out=None) -> torch.Tensor:
    """K1b: W = L⁻¹ from ``chol_factor``'s outputs; kernel on CUDA.  With
    ``out`` the result goes there, and matrices whose ``skip`` flag is set
    keep what ``out`` holds."""
    if L.device.type == "cpu":
        return chol_winv_plain(L, Wd, skip, out)
    native.require_cuda("chol_winv", L, Wd)
    B, Np, _ = L.shape
    if Np % TILE or Wd.shape != (B, Np // TILE, TILE, TILE):
        raise ValueError(f"chol_winv: bad shapes L {tuple(L.shape)}, Wd {tuple(Wd.shape)}")
    _skip_args("chol_winv", B, Np, skip, None if out is None else (out,), ((B, Np, Np),))
    if skip is not None:
        native.require_cuda("chol_winv", skip, dtype=torch.int32)
    W = torch.empty_like(L) if out is None else out
    native.require_cuda("chol_winv", L, W)
    S = torch.empty_like(L) if Np > TILE else W  # scratch: L21 W11 per level
    lib = native.load("chol")
    err = native.call(lib.hebo_chol_winv, L.device, L.data_ptr(), Wd.data_ptr(), _ptr(skip),
                      W.data_ptr(), S.data_ptr(), B, Np)
    native.check(err, "chol_winv")
    chol_winv.launches += 1
    return W


chol_factor.launches = 0
chol_winv.launches = 0


def chol_inv(K: torch.Tensor):
    """(L, W) with K = L Lᵀ and W = L⁻¹ for a (B, n, n) float32 batch."""
    n = K.shape[-1]
    L, Wd = chol_factor(K)
    W = chol_winv(L, Wd)
    return L[:, :n, :n], W[:, :n, :n]


def cholesky_batched(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor (zeros above the diagonal) of a (B, N, N)
    float32 batch; NaNs in a non-PSD member's factor.  K1a on CUDA."""
    n = K.shape[-1]
    return chol_factor(K)[0][:, :n, :n]


# (L, W) with K = L Lᵀ and W = L⁻¹, each (B, N, N): K1 on CUDA
chol_inv_batched = chol_inv


def _block16_plain(a: torch.Tensor):
    """(L, L⁻¹) of a (B, 16, 16) batch by the column loop that one warp of
    the CUDA tile factor runs: each step yields an L column and an L⁻¹ row
    (the rows below take one row operation each).  A pivot that is not
    > 0 gives NaN."""
    a = a.clone()
    x = torch.eye(SUB, dtype=a.dtype).expand_as(a).clone()
    for k in range(SUB):
        d = a[:, k, k]
        piv = torch.where(d > 0, d.clamp(min=0).sqrt(), torch.full_like(d, float("nan")))
        lk = a[:, :, k] / piv[:, None]
        lk[:, :k] = 0.0
        lk[:, k] = piv
        x[:, k] = x[:, k] / piv[:, None]
        a[:, k + 1:, k + 1:] -= lk[:, k + 1:, None] * lk[:, None, k + 1:]
        x[:, k + 1:] -= lk[:, k + 1:, None] * x[:, None, k]
        a[:, :, k] = lk
    return torch.tril(a), torch.tril(x)


def _tile_factor_plain(A: torch.Tensor):
    """(L, L⁻¹) of a (B, 64, 64) SPD batch in the CUDA tile factor's order:
    per 16-wide sub-panel, the 16×16 diagonal block (``_block16_plain``),
    the sub-panel solve and the sub-trailing update; then L⁻¹'s
    off-diagonal blocks by doubling over 16 and 32."""
    A = A.clone()
    X = torch.zeros_like(A)
    for o in range(0, TILE, SUB):
        d_ = slice(o, o + SUB)
        A[:, d_, d_], X[:, d_, d_] = _block16_plain(A[:, d_, d_])
        r = slice(o + SUB, TILE)
        A[:, r, d_] = A[:, r, d_] @ X[:, d_, d_].transpose(1, 2)
        A[:, r, r] -= A[:, r, d_] @ A[:, r, d_].transpose(1, 2)
    h = SUB
    while h < TILE:
        for s1 in range(0, TILE, 2 * h):
            b1, b2 = slice(s1, s1 + h), slice(s1 + h, s1 + 2 * h)
            X[:, b2, b1] = -X[:, b2, b2] @ (A[:, b2, b1] @ X[:, b1, b1])
        h *= 2
    return torch.tril(A), X


def _flow_tasks(nt: int):
    """K1a's flow tasks (i, k) in ticket order (``csrc/chol.cu::chol_flow``):
    (0, 0), (1, 0), (1, 1), then per column c the chain's next three tasks,
    (c+2, c), (c+2, c+1) and (c+2, c+2), and the rest of column c,
    (c+3 .. nt-1, c)."""
    order = [(0, 0), (1, 0), (1, 1)][: nt * (nt + 1) // 2]
    for c in range(nt - 2):
        order += [(c + 2, c), (c + 2, c + 1), (c + 2, c + 2)] + [(i, c) for i in range(c + 3, nt)]
    return order


def _schedule_plain(K: torch.Tensor, route: str = "step"):
    """(L, Wd, W) of a (B, n, n) float32 CPU batch by the block schedule of
    ``csrc/chol.cu``, for the CPU tests only.  K1a, ``route`` "step": tile
    (0, 0), then for each panel j every trailing tile forms its panel tiles
    L_ij = A_ij Wd_jᵀ and takes A_ik −= L_ij L_kjᵀ, and tile (j+1, j+1) is
    factored at once.  "flow": task by task in ticket order (``_flow_tasks``):
    C = A_ik − Σ_{j<k} L_ij L_kjᵀ, each of the four 16-wide quarters of the
    depth summed over j apart and the four sums added in order; then the
    diagonal tile is factored, the subdiagonal one stores C, which the next
    diagonal task turns into L_{k,k-1} = C Wd_{k-1}ᵀ and subtracts
    L_{k,k-1} L_{k,k-1}ᵀ from its own C (summed over j < k − 1) before its
    factor, and any other gives L_ik = C Wd_kᵀ.  A task that read a tile
    before the task that forms it would read zeros or C: the order is
    checked too.
    K1b: W's diagonal tiles are Wd; at level h = 1, 2, 4, … tiles each pair
    of diagonal blocks (the second cut at nt) gets W21 = −W22 (L21 W11)."""
    if route not in ROUTES:
        raise ValueError(f"_schedule_plain: route {route!r}, expected one of {ROUTES}")
    B, n, _ = K.shape
    Np = padded_size(n)
    nt = Np // TILE

    def tl(i, j=None):
        return slice(i * TILE, (i + 1 if j is None else j) * TILE)

    A = _pad_identity(K, Np).clone()
    L = torch.zeros_like(A)
    Wd = torch.empty((B, nt, TILE, TILE), dtype=K.dtype)
    if route == "step":
        L[:, tl(0), tl(0)], Wd[:, 0] = _tile_factor_plain(A[:, tl(0), tl(0)])
        for j in range(nt - 1):
            rest = tl(j + 1, nt)
            P = A[:, rest, tl(j)] @ Wd[:, j].transpose(1, 2)
            L[:, rest, tl(j)] = P
            A[:, rest, rest] -= P @ P.transpose(1, 2)
            L[:, tl(j + 1), tl(j + 1)], Wd[:, j + 1] = _tile_factor_plain(A[:, tl(j + 1), tl(j + 1)])
    else:
        for i, k in _flow_tasks(nt):
            parts = [torch.zeros((B, TILE, TILE), dtype=K.dtype) for _ in range(TILE // SUB)]

            def take(j):
                for g, part in enumerate(parts):
                    q = slice(j * TILE + g * SUB, j * TILE + (g + 1) * SUB)
                    part += L[:, tl(i), q] @ L[:, tl(k), q].transpose(1, 2)

            for j in range(k - 1 if i == k and k > 0 else k):
                take(j)
            s = parts[0]
            for part in parts[1:]:
                s = s + part
            C = A[:, tl(i), tl(k)] - s
            if i == k and k > 0:  # L_{k,k-1} from the subdiagonal task's stored sum
                Lk = L[:, tl(k), tl(k - 1)] @ Wd[:, k - 1].transpose(1, 2)
                L[:, tl(k), tl(k - 1)] = Lk
                C = C - Lk @ Lk.transpose(1, 2)
            if i == k:
                L[:, tl(k), tl(k)], Wd[:, k] = _tile_factor_plain(C)
            elif i == k + 1:
                L[:, tl(i), tl(k)] = C
            else:
                L[:, tl(i), tl(k)] = C @ Wd[:, k].transpose(1, 2)
    W = torch.zeros_like(L)
    for t in range(nt):
        W[:, tl(t), tl(t)] = Wd[:, t]
    h = 1
    while h < nt:
        for s1 in range(0, nt - h, 2 * h):
            b1, b2 = tl(s1, s1 + h), tl(s1 + h, min(s1 + 2 * h, nt))
            W[:, b2, b1] = -W[:, b2, b2] @ (L[:, b2, b1] @ W[:, b1, b1])
        h *= 2
    return L, Wd, W
