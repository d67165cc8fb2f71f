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
tensor it runs ``matern32_gram_plain``, the same expansion form in PyTorch.
The gradient is a ``torch.autograd.Function`` whose backward differentiates
the plain form, as the JAX package's custom VJP (pallas_gram.py:128-133)
differentiates its jnp form: neither package has a backward kernel.
"""

from __future__ import annotations

import math

import torch

from . import native

__all__ = ["matern32_gram", "matern32_gram_plain"]

_SQRT3 = math.sqrt(3.0)


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


def _launch(a, b, sc, jitter):
    native.require_cuda("matern32_gram", a, b, sc)
    B, N, D = a.shape
    if b.shape[0] != B or b.shape[2] != D or sc.shape != (B,):
        raise ValueError(
            f"matern32_gram: shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
            f"sc {tuple(sc.shape)} do not agree"
        )
    M = b.shape[1]
    lib = native.load("gram")
    out = torch.empty((B, N, M), dtype=torch.float32, device=a.device)
    err = native.call(
        lib.hebo_matern32_gram, a.device, a.data_ptr(), b.data_ptr(), sc.data_ptr(),
        float(jitter), out.data_ptr(), B, N, M, D,
    )
    native.check(err, "matern32_gram")
    matern32_gram.launches += 1
    return out


class _Matern32Gram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, sc, jitter):
        ctx.save_for_backward(a, b, sc)
        return _launch(a, b, sc, jitter)

    @staticmethod
    def backward(ctx, g):
        a, b, sc = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip((a, b, sc), need)]
            K = matern32_gram_plain(*ins)
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(K, wrt, g) if wrt else ())
        return tuple(next(grads) if n else None for n in need) + (None,)


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
