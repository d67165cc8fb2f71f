"""Kernel K2: the fused ARD Matérn-3/2 Gram (``csrc/gram.cu``).

Replaces the Pallas kernel ``hebo_tpu/ops/pallas_gram.py::_kernel`` (both
``pallas_call`` sites, :87 and :164).  It takes a batch, because the port's
restarts and ensemble samples are an explicit leading axis where the JAX
package used ``vmap``:

    a (B, N, D), b (B, M, D)  — already scaled by 1/ℓ per batch entry,
    sc (B,)                   — outputscale per batch entry,
    jitter                    — added on the global diagonal,
    →  K (B, N, M) = sc·(1+s)·e^{−s},  s = √3·√(max(‖a‖²+‖b‖²−2abᵀ, 0)+1e-16).

On a CUDA tensor ``matern32_gram`` launches the kernel (or raises); on a CPU
tensor it runs ``matern32_gram_plain``, the same expansion form in PyTorch,
under autograd.  On CUDA the gradient is a ``torch.autograd.Function`` whose
backward launches the VJP kernel (``matern32_gram_vjp``), in place of the
XLA-fused VJP of the JAX package's jnp form (pallas_gram.py:128-133).  Its
closed form, ``matern32_gram_vjp_plain``, with G = −3·sc·g·e^{−s}·[d² ≥ 0]:

    ga = a·Σ_j G − G b,   gb = b·Σ_i G − Gᵀ a,   gsc = Σ g·(1+s)·e^{−s}.

Both kernels take their tile rows from one rule in ``csrc/gram.cu``
(``pick_rows``), which ``tile_rows`` reports.
"""

from __future__ import annotations

import math

import torch

from . import native

__all__ = ["matern32_gram", "matern32_gram_plain", "matern32_gram_vjp", "matern32_gram_vjp_plain",
           "tile_rows"]

_SQRT3 = math.sqrt(3.0)
_TILE_COLS = 64  # columns per CTA tile of both kernels (csrc/gram.cu kCols)


def matern32_gram_plain(a: torch.Tensor, b: torch.Tensor, sc: torch.Tensor,
                        jitter: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same math, same expansion)."""
    an = (a * a).sum(-1)[..., :, None]
    bn = (b * b).sum(-1)[..., None, :]
    d2 = torch.clamp(an + bn - 2.0 * (a @ b.transpose(-1, -2)), min=0.0)
    s = _SQRT3 * torch.sqrt(d2 + 1e-16)
    K = sc[:, None, None] * ((1.0 + s) * torch.exp(-s))
    if jitter:
        N, M = K.shape[-2:]
        K = K + jitter * torch.eye(N, M, dtype=K.dtype, device=K.device)
    return K


def matern32_gram_vjp_plain(a: torch.Tensor, b: torch.Tensor, sc: torch.Tensor,
                            g: torch.Tensor):
    """(ga, gb, gsc): the closed-form VJP of ``matern32_gram_plain`` against
    the cotangent g (B, N, M), in plain PyTorch (the same expansion form;
    the clamp passes the gradient where d² ≥ 0)."""
    an = (a * a).sum(-1)[..., :, None]
    bn = (b * b).sum(-1)[..., None, :]
    d2 = an + bn - 2.0 * (a @ b.transpose(-1, -2))
    s = _SQRT3 * torch.sqrt(torch.clamp(d2, min=0.0) + 1e-16)
    e = torch.exp(-s)
    G = torch.where(d2 >= 0, -3.0 * sc[:, None, None] * g * e, torch.zeros_like(e))
    ga = a * G.sum(-1)[..., None] - G @ b
    gb = b * G.sum(-2)[..., None] - G.transpose(-1, -2) @ a
    return ga, gb, (g * (1.0 + s) * e).sum((-2, -1))


def _shapes(what, a, b, sc):
    B, N, D = a.shape
    if b.shape[0] != B or b.shape[2] != D or sc.shape != (B,):
        raise ValueError(
            f"{what}: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"sc {tuple(sc.shape)} do not agree"
        )
    return B, N, b.shape[1], D


def tile_rows(B: int, N: int, M: int) -> int:
    """Rows per CTA tile (64, 32 or 16) that K2's kernels take at this
    shape, as ``csrc/gram.cu::pick_rows`` decides it on the current card."""
    return native.load("gram").hebo_matern32_gram_rows(B, N, M)


def _launch(a, b, sc, jitter):
    native.require_cuda("matern32_gram", a, b, sc)
    B, N, M, D = _shapes("matern32_gram", a, b, sc)
    lib = native.load("gram")
    out = torch.empty((B, N, M), dtype=torch.float32, device=a.device)
    err = native.call(
        lib.hebo_matern32_gram, a.device, a.data_ptr(), b.data_ptr(), sc.data_ptr(),
        float(jitter), out.data_ptr(), B, N, M, D,
    )
    native.check(err, "matern32_gram")
    matern32_gram.launches += 1
    return out


def matern32_gram_vjp(a: torch.Tensor, b: torch.Tensor, sc: torch.Tensor,
                      g: torch.Tensor):
    """(ga (B,N,D), gb (B,M,D), gsc (B,)): the VJP of ``matern32_gram``
    against g (B,N,M).  CUDA tensors go through the kernel (two launches:
    per-tile partial sums, then their sum in tile order), CPU tensors
    through ``matern32_gram_vjp_plain``."""
    if a.device.type == "cpu":
        return matern32_gram_vjp_plain(a, b, sc, g)
    native.require_cuda("matern32_gram_vjp", a, b, sc, g)
    B, N, M, D = _shapes("matern32_gram_vjp", a, b, sc)
    if g.shape != (B, N, M):
        raise ValueError(f"matern32_gram_vjp: g {tuple(g.shape)}, expected {(B, N, M)}")
    if g.data_ptr() % 16:  # the kernel reads g in 16-byte pieces
        g = g.clone()
    lib = native.load("gram")
    Rt = -(-N // lib.hebo_matern32_gram_rows(B, N, M))
    Ct = -(-M // _TILE_COLS)
    out = torch.empty(B * (N + M) * D + B, dtype=torch.float32, device=a.device)
    scratch = torch.empty(B * (Ct * N * D + Rt * M * D + Rt * Ct), dtype=torch.float32,
                          device=a.device)
    ga, gb, gsc = out.split([B * N * D, B * M * D, B])
    err = native.call(
        lib.hebo_matern32_gram_vjp, a.device, a.data_ptr(), b.data_ptr(), sc.data_ptr(),
        g.data_ptr(), scratch.data_ptr(), ga.data_ptr(), gb.data_ptr(), gsc.data_ptr(),
        B, N, M, D,
    )
    native.check(err, "matern32_gram_vjp")
    matern32_gram_vjp.launches += 1
    return ga.view(B, N, D), gb.view(B, M, D), gsc


class _Matern32Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, sc, jitter):
        ctx.save_for_backward(a, b, sc)
        return _launch(a, b, sc, jitter)

    @staticmethod
    def backward(ctx, g):
        grads = matern32_gram_vjp(*ctx.saved_tensors, g.contiguous())
        return tuple(t if n else None for t, n in zip(grads, ctx.needs_input_grad)) + (None,)


def matern32_gram(a: torch.Tensor, b: torch.Tensor, sc: torch.Tensor,
                  jitter: float = 0.0) -> torch.Tensor:
    """K (B, N, M) from a (B, N, D), b (B, M, D), sc (B,); differentiable in
    a, b and sc.  CUDA tensors go through the kernel, CPU tensors through
    the plain version."""
    if a.device.type == "cpu":
        return matern32_gram_plain(a, b, sc, jitter)
    if a.device.type != "cuda":
        raise ValueError(f"matern32_gram: unsupported device {a.device}")
    return _Matern32Gram.apply(a, b, sc, float(jitter))


matern32_gram.launches = 0
matern32_gram_vjp.launches = 0
