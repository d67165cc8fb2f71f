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

Where K1a takes its flow route (from 8 tiles), ``chol_factor_inv`` gives
(L, Wd, W) in one launch pair (``chol_flow_inv``: K1a's tasks and K1b's on
one ticket counter, with K1a's and K1b's bits); ``factor_inv`` takes it
there and the pair below, and the jitter ladder and ``chol_inv`` call
``factor_inv``.

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
(1, 5051)), at any batch; ``chol_factor(..., route=)`` forces one.  Both
compute the same function; their sums run in other orders.  K1b's route
(``winv_route``; the rule is ``pick_winv_route``) follows from the size:
"copy", one launch that copies Wd, at one tile (N ≤ 64), and "flow", one
persistent launch of blocked forward substitution, from 2 tiles.

``_schedule_plain`` mirrors, in plain PyTorch, the block schedule that the
CUDA kernels run (16-wide sub-blocked tile factor; K1a's look-ahead panel
steps or its left-looking tasks; K1b's forward-substitution tasks; the
fused route's interleaved order of both); only the CPU tests call it.
"""

from __future__ import annotations

import functools

import torch

from . import native

__all__ = [
    "TILE", "ROUTES", "WINV_ROUTES", "padded_size", "route", "winv_route", "chol_factor", "chol_factor_plain",
    "chol_winv", "chol_winv_plain", "chol_factor_inv", "chol_factor_inv_plain", "factor_inv", "chol_inv",
    "cholesky_batched", "chol_inv_batched",
]

TILE = 64
SUB = 16  # sub-block edge of the CUDA tile factor
ROUTES = ("step", "flow")  # K1a's routes, by the number csrc/chol.cu gives them
WINV_ROUTES = ("copy", "flow")  # K1b's
WINV_LAG = 4  # the fused order's lag of W's rows (csrc/chol.cu kWinvLag)


def padded_size(n: int) -> int:
    return max(TILE, -(-n // TILE) * TILE)


@functools.lru_cache(maxsize=None)
def _route_code(Np: int) -> int:
    # the rule reads the padded size alone, so one library call per size
    return native.load("chol").hebo_chol_route(Np)


@functools.lru_cache(maxsize=None)
def _winv_route_code(Np: int) -> int:
    return native.load("chol").hebo_chol_winv_route(Np)


def route(n: int) -> str:
    """The route K1a takes on the card for matrices of size n (any batch),
    as ``csrc/chol.cu::pick_route`` decides it."""
    return ROUTES[_route_code(padded_size(int(n)))]


def winv_route(n: int) -> str:
    """The route K1b takes on the card for matrices of size n (any batch),
    as ``csrc/chol.cu::pick_winv_route`` decides it."""
    return WINV_ROUTES[_winv_route_code(padded_size(int(n)))]


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
    lib = native.load("chol")
    # the flow route's counters: 1 per tile column and the ticket, per matrix
    sync = torch.empty(B * (Np // TILE + 1), dtype=torch.int32, device=L.device) if Np > TILE else None
    err = native.call(lib.hebo_chol_winv, L.device, L.data_ptr(), Wd.data_ptr(), _ptr(skip),
                      W.data_ptr(), _ptr(sync), B, Np)
    native.check(err, "chol_winv")
    chol_winv.launches += 1
    return W


def chol_factor_inv_plain(K: torch.Tensor, jitter=None, skip=None, out=None):
    """Plain version of the fused call: ``chol_factor_plain`` then
    ``chol_winv_plain``, (L, Wd, W) written into ``out`` except where
    ``skip`` is set."""
    B, n, _ = K.shape
    Np = padded_size(n)
    _skip_args("chol_factor_inv", B, Np, skip, out,
               ((B, Np, Np), (B, Np // TILE, TILE, TILE), (B, Np, Np)))
    L, Wd = chol_factor_plain(K, jitter, skip, None if out is None else out[:2])
    W = chol_winv_plain(L, Wd, skip, None if out is None else out[2])
    return L, Wd, W


def chol_factor_inv(K: torch.Tensor, jitter=None, skip=None, out=None):
    """K1 in one launch pair: (L, Wd, W = L⁻¹) for K (B, n, n) float32 plus
    ``jitter`` (B,) on its diagonal, where K1a takes its flow route
    (``route(n) == "flow"``, from 8 tiles); the bits of ``chol_factor``
    then ``chol_winv``.  Kernel on CUDA (a smaller n raises), plain on CPU.
    ``out`` and ``skip`` as for ``chol_factor``, with W's buffer third."""
    if K.device.type == "cpu":
        return chol_factor_inv_plain(K, jitter, skip, out)
    native.require_cuda("chol_factor_inv", K)
    B, n, n2 = K.shape
    if n != n2:
        raise ValueError(f"chol_factor_inv: expected square matrices, got {tuple(K.shape)}")
    Np = padded_size(n)
    if ROUTES[_route_code(Np)] != "flow":
        raise ValueError(f"chol_factor_inv: n {n} is below K1a's flow route (8 tiles, n > 448); "
                         "use chol_factor and chol_winv")
    _skip_args("chol_factor_inv", B, Np, skip, out,
               ((B, Np, Np), (B, Np // TILE, TILE, TILE), (B, Np, Np)))
    if jitter is not None:
        native.require_cuda("chol_factor_inv", K, jitter)
        if jitter.shape != (B,):
            raise ValueError(f"chol_factor_inv: jitter {tuple(jitter.shape)}, expected {(B,)}")
    if skip is not None:
        native.require_cuda("chol_factor_inv", skip, dtype=torch.int32)
    if out is None:
        L = torch.empty((B, Np, Np), dtype=torch.float32, device=K.device)
        Wd = torch.empty((B, Np // TILE, TILE, TILE), dtype=torch.float32, device=K.device)
        W = torch.empty_like(L)
    else:
        L, Wd, W = out
        native.require_cuda("chol_factor_inv", K, L, Wd, W)
    # each matrix's counters: K1a's 2 per tile row, W's 1 per tile column, its ticket
    sync = torch.empty(B * (3 * (Np // TILE) + 1), dtype=torch.int32, device=K.device)
    err = native.call(native.load("chol").hebo_chol_factor_inv, K.device, K.data_ptr(), _ptr(jitter),
                      _ptr(skip), L.data_ptr(), Wd.data_ptr(), W.data_ptr(), sync.data_ptr(), B, n, Np)
    native.check(err, "chol_factor_inv")
    chol_factor_inv.launches += 1
    return L, Wd, W


chol_factor.launches = 0
chol_winv.launches = 0
chol_factor_inv.launches = 0


def factor_inv(K: torch.Tensor, jitter=None, skip=None, out=None):
    """(L, Wd, W = L⁻¹) of K + diag(jitter), ``skip`` and ``out`` as for
    ``chol_factor_inv``: on CUDA one ``chol_factor_inv`` call where K1a
    takes its flow route, else ``chol_factor`` then ``chol_winv``; on CPU
    the plain pair."""
    if K.device.type != "cpu" and route(K.shape[-1]) == "flow":
        return chol_factor_inv(K, jitter, skip, out)
    L, Wd = chol_factor(K, jitter, skip, None if out is None else out[:2])
    return L, Wd, chol_winv(L, Wd, skip, None if out is None else out[2])


def chol_inv(K: torch.Tensor):
    """(L, W) with K = L Lᵀ and W = L⁻¹ for a (B, n, n) float32 batch."""
    n = K.shape[-1]
    L, _, W = factor_inv(K)
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
    off-diagonal blocks by doubling over 16 and 32.  The kernel runs the
    blocks' factors on one warp and the rest beside them (the next diagonal
    block's solve and update first, then the others and each doubling
    product as soon as its blocks are there), each entry summed in this
    order, so the schedule changes no bit."""
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


def _winv_flow_tasks(nt: int):
    """K1b's flow tasks (i, k) in ticket order (``csrc/chol.cu::winv_flow``):
    row by row, (i, 0) .. (i, i − 1), then the diagonal (i, i)."""
    return [(i, k) for i in range(nt) for k in range(i + 1)]


def _winv_slot(w: int, nt: int, lag: int = WINV_LAG) -> int:
    """The column of K1a's tasks after which W's row w takes its tickets
    in the fused order (``csrc/chol.cu::winv_slot``; −1: after the first
    three)."""
    return min(max(w - 2, -1) + lag, nt - 3)


def _fused_flow_tasks(nt: int, lag: int = WINV_LAG):
    """The fused route's tasks ("L" or "W", i, k) in ticket order
    (``csrc/chol.cu::fused_ticket``): K1a's flow tasks in their order
    (``_flow_tasks``), and W's row w, (w, 0) .. (w, w), right after K1a's
    tasks of column ``_winv_slot(w)``, ``lag`` columns after the column
    whose tasks hold L's diagonal task (w, w)."""
    order = [("L", i, k) for i, k in [(0, 0), (1, 0), (1, 1)][: nt * (nt + 1) // 2]]
    w = 0
    for c in range(-1, nt - 2):
        if c >= 0:
            order += [("L", c + 2, c), ("L", c + 2, c + 1), ("L", c + 2, c + 2)]
            order += [("L", i, c) for i in range(c + 3, nt)]
        while w < nt and _winv_slot(w, nt, lag) == c:
            order += [("W", w, k) for k in range(w + 1)]
            w += 1
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
    K1b (its flow route; at one tile it gives the copy W = Wd): task by
    task in ticket order (``_winv_flow_tasks``) on a W that starts at
    zeros: W_ii = Wd_i, and
    W_ik = −Wd_i Σ_{j=k}^{i−1} L_ij W_jk with W_kk read as Wd_k, each of the
    four 16-wide quarters of the depth summed over j apart (the last term
    L_{i,i−1} W_{i−1,k} last) and the four sums added in order; the task
    zeros W_ki.  A task that read a tile before the task that forms it would
    read zeros: the order is checked too.
    "fused": the tasks of "flow" and of K1b's flow route interleaved in the
    fused route's ticket order (``_fused_flow_tasks``), each with its own
    arithmetic, on an L, Wd and W that start at zeros: the same (L, Wd, W)
    where the order is topological."""
    if route not in ROUTES + ("fused",):
        raise ValueError(f"_schedule_plain: route {route!r}, expected one of {ROUTES + ('fused',)}")
    B, n, _ = K.shape
    Np = padded_size(n)
    nt = Np // TILE

    def tl(i, j=None):
        return slice(i * TILE, (i + 1 if j is None else j) * TILE)

    A = _pad_identity(K, Np).clone()
    L = torch.zeros_like(A)
    Wd = torch.zeros((B, nt, TILE, TILE), dtype=K.dtype)
    W = torch.zeros_like(L)

    def factor_task(i, k):
        parts = [torch.zeros((B, TILE, TILE), dtype=K.dtype) for _ in range(TILE // SUB)]
        for j in range(k - 1 if i == k and k > 0 else k):
            for g, part in enumerate(parts):
                q = slice(j * TILE + g * SUB, j * TILE + (g + 1) * SUB)
                part += L[:, tl(i), q] @ L[:, tl(k), q].transpose(1, 2)
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

    def winv_task(i, k):
        if i == k:
            W[:, tl(i), tl(i)] = Wd[:, i]
            return
        parts = [torch.zeros((B, TILE, TILE), dtype=K.dtype) for _ in range(TILE // SUB)]
        for j in range(k, i):
            Wjk = Wd[:, k] if j == k else W[:, tl(j), tl(k)]
            for g, part in enumerate(parts):
                q = slice(g * SUB, (g + 1) * SUB)
                part += L[:, tl(i), tl(j)][:, :, q] @ Wjk[:, q]
        s = parts[0]
        for part in parts[1:]:
            s = s + part
        W[:, tl(i), tl(k)] = -(Wd[:, i] @ s)
        W[:, tl(k), tl(i)] = 0.0

    if route == "step":
        L[:, tl(0), tl(0)], Wd[:, 0] = _tile_factor_plain(A[:, tl(0), tl(0)])
        for j in range(nt - 1):
            rest = tl(j + 1, nt)
            P = A[:, rest, tl(j)] @ Wd[:, j].transpose(1, 2)
            L[:, rest, tl(j)] = P
            A[:, rest, rest] -= P @ P.transpose(1, 2)
            L[:, tl(j + 1), tl(j + 1)], Wd[:, j + 1] = _tile_factor_plain(A[:, tl(j + 1), tl(j + 1)])
    elif route == "flow":
        for i, k in _flow_tasks(nt):
            factor_task(i, k)
    else:
        for kind, i, k in _fused_flow_tasks(nt):
            (factor_task if kind == "L" else winv_task)(i, k)
        return L, Wd, W
    for i, k in _winv_flow_tasks(nt):
        winv_task(i, k)
    return L, Wd, W
