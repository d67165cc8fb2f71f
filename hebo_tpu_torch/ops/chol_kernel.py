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

Failure semantics: a non-PSD matrix yields NaNs in its own L and W and in
no other matrix of the batch.  The plain version gets there by NaN-filling
the matrices whose ``cholesky_ex`` ``info`` is non-zero, because
``cholesky_ex`` itself returns a finite, wrong factor for them.
"""

from __future__ import annotations

import torch

from . import native

__all__ = [
    "TILE", "padded_size", "chol_factor", "chol_factor_plain", "chol_winv",
    "chol_winv_plain", "chol_inv", "cholesky_batched", "chol_inv_batched",
]

TILE = 64


def padded_size(n: int) -> int:
    return max(TILE, -(-n // TILE) * TILE)


def _pad_identity(K: torch.Tensor, Np: int) -> torch.Tensor:
    B, n, _ = K.shape
    if Np == n:
        return K
    Kp = torch.eye(Np, dtype=K.dtype, device=K.device).repeat(B, 1, 1)
    Kp[:, :n, :n] = K
    return Kp


def chol_factor_plain(K: torch.Tensor):
    """Plain version of K1a: (L, Wd) of the identity-padded batch."""
    B, n, _ = K.shape
    Np = padded_size(n)
    L, info = torch.linalg.cholesky_ex(_pad_identity(K, Np))
    L = torch.where((info != 0)[:, None, None], torch.full_like(L, float("nan")), L)
    nt = Np // TILE
    Ld = torch.stack(
        [L[:, t * TILE:(t + 1) * TILE, t * TILE:(t + 1) * TILE] for t in range(nt)], 1
    )
    eye = torch.eye(TILE, dtype=K.dtype, device=K.device).expand_as(Ld)
    Wd = torch.linalg.solve_triangular(Ld, eye, upper=False)
    return L, Wd


def chol_winv_plain(L: torch.Tensor, Wd: torch.Tensor) -> torch.Tensor:
    """Plain version of K1b: W = L⁻¹ (``Wd`` is implied by ``L``)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def chol_factor(K: torch.Tensor):
    """K1a: (L, Wd) for K (B, n, n) float32; kernel on CUDA, plain on CPU."""
    if K.device.type == "cpu":
        return chol_factor_plain(K)
    native.require_cuda("chol_factor", K)
    B, n, n2 = K.shape
    if n != n2:
        raise ValueError(f"chol_factor: expected square matrices, got {tuple(K.shape)}")
    Np = padded_size(n)
    L = torch.empty((B, Np, Np), dtype=torch.float32, device=K.device)
    Wd = torch.empty((B, Np // TILE, TILE, TILE), dtype=torch.float32, device=K.device)
    lib = native.load("chol")
    with torch.cuda.device(K.device):
        err = lib.hebo_chol_factor(
            K.data_ptr(), L.data_ptr(), Wd.data_ptr(), B, n, Np,
            native.stream_handle(K.device),
        )
    native.check(err, "chol_factor")
    chol_factor.launches += 1
    return L, Wd


def chol_winv(L: torch.Tensor, Wd: torch.Tensor) -> torch.Tensor:
    """K1b: W = L⁻¹ from ``chol_factor``'s outputs; kernel on CUDA."""
    if L.device.type == "cpu":
        return chol_winv_plain(L, Wd)
    native.require_cuda("chol_winv", L, Wd)
    B, Np, _ = L.shape
    if Np % TILE or Wd.shape != (B, Np // TILE, TILE, TILE):
        raise ValueError(f"chol_winv: bad shapes L {tuple(L.shape)}, Wd {tuple(Wd.shape)}")
    W = torch.empty_like(L)
    lib = native.load("chol")
    with torch.cuda.device(L.device):
        err = lib.hebo_chol_winv(
            L.data_ptr(), Wd.data_ptr(), W.data_ptr(), B, Np,
            native.stream_handle(L.device),
        )
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
