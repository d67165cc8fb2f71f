"""Kernel K3: the string-subsequence-kernel (SSK) Gram (``csrc/ssk.cu``).

Replaces the Pallas kernels of ``hebo_tpu/ops/pallas_ssk.py``:
``_cross_kernel`` (pallas_call :148) becomes ``ssk_cross`` and
``_self_kernel`` (pallas_call :167) becomes ``ssk_self``.  Both take the
codes shared by the batch and one (λ_m², λ_g) per batch entry, where the
JAX package ``vmap``s over restarts and ensemble samples:

    s1 (N, L), s2 (M, L)  — integer codes (any dtype holding whole numbers),
    lam2 (B,), gap (B,)   — squared match decay and gap decay,
    →  raw totals (B, N, M) and their tangents ∂/∂λ_m², ∂/∂λ_g
       (``ssk_self``: the pairs (i, i) of one set, (B, N) each).

On a CUDA tensor each wrapper launches its kernel (or raises) and adds one
to its ``launches`` count; on a CPU tensor it runs its plain version, the
JAX package's dense form (``_dp_flat``: D[i,j] = λ_g^{j−i−1}, each DP step
Dᵀ·K·D with the tangent chains alongside) as batched einsums.

``ssk_gram`` normalises, K = c/√(a·b), and is differentiable in the match
and gap decays: as ``_ssk_norm_fwd`` (pallas_ssk.py:199-215) the tangents of
K come out of the forward pass, and the backward (a ``torch.autograd.Function``
for the custom VJP :218-228) returns Σ g·∂K/∂λ_m² and Σ g·∂K/∂λ_g for each
batch entry.  The codes get no gradient.  ``ssk_gram_plain`` is the same
function over the plain versions.

The kernel picks one of four routes by (L, P) and the launch's pair count
(``csrc/ssk.cu::pick_route``, reported by ``route``): ``regs`` (one thread
per pair, state in registers, L ≤ 11 at P ≤ 3 and L ≤ 8 at P = 4, 5),
``regs32`` (the same for 12 ≤ L ≤ 32 at P ≤ 3, column bound 32), ``warp`` (12 ≤ L ≤ 32 at P ≤ 3 when B·pairs is small: one warp per
pair, lane = column, rows as a wavefront across the lanes) and ``smem``
(everything beyond those register budgets).  ``ssk_scan_plain`` is the
kernel's recursion in plain torch, for the CPU tests.

Tolerances of the kernel against the plain version (sums in another order):
raw totals 1e-5 relative, normalised K 1e-5 absolute (K ∈ [0, 1]), tangents
1e-4 relative.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from . import native

__all__ = [
    "decay_mats", "route", "ssk_cross", "ssk_cross_plain", "ssk_scan_plain",
    "ssk_self", "ssk_self_plain", "ssk_gram", "ssk_gram_plain",
]

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

ROUTES = ("regs", "smem", "regs32", "warp")


def route(L: int, P: int, work: int) -> str:
    """The route K3 takes on the card for strings of length L and max_subseq
    P at a launch of ``work`` = B·pairs (B·N·M for ``ssk_cross``, B·N for
    ``ssk_self``), as the built kernel reports it
    (``csrc/ssk.cu::pick_route``)."""
    return ROUTES[native.load("ssk").hebo_ssk_route(int(L), int(P), int(work))]


def decay_mats(gap: torch.Tensor, L: int):
    """Gap transfer matrices D[i,j] = λ_g^{j−i−1} (j > i) and ∂D/∂λ_g, each
    (B, L, L) for gap (B,) (pallas_ssk.py:45)."""
    idx = torch.arange(L, device=gap.device)
    p = (idx[None, :] - idx[:, None] - 1).to(gap.dtype)
    g = gap[:, None, None]
    zero = torch.zeros((), dtype=gap.dtype, device=gap.device)
    D = torch.where(p >= 0, g ** torch.clamp(p, min=0.0), zero)
    dD = torch.where(p >= 1, p * g ** torch.clamp(p - 1.0, min=0.0), zero)
    return D, dD


def _dp_plain(match: torch.Tensor, lam2: torch.Tensor, gap: torch.Tensor,
              max_subseq: int) -> Triple:
    """The DP with forward tangents on match (*S, L, L) → 3 × (B, *S)
    (``_dp_flat``, pallas_ssk.py:64-92, in the unflattened D form)."""
    D, dD = decay_mats(gap, match.shape[-1])
    extra = (1,) * (match.dim() - 2)
    shape = (-1,) + extra + (1, 1)
    l2 = lam2.reshape(shape)
    Dv, dDv = D.reshape((-1,) + extra + D.shape[-2:]), dD.reshape((-1,) + extra + D.shape[-2:])

    def step(K, A, B):  # Aᵀ K B over the last two axes
        return A.transpose(-1, -2) @ K @ B

    Kp = match * l2
    Kp_l = match.expand_as(Kp)
    Kp_g = torch.zeros_like(Kp)
    tot = Kp.sum((-2, -1))
    tot_l = Kp_l.sum((-2, -1))
    tot_g = torch.zeros_like(tot)
    for _ in range(1, max_subseq):
        inner = step(Kp, Dv, Dv)
        inner_l = step(Kp_l, Dv, Dv)
        inner_g = step(Kp, dDv, Dv) + step(Kp, Dv, dDv) + step(Kp_g, Dv, Dv)
        Kp_l = match * (inner + l2 * inner_l)
        Kp_g = l2 * match * inner_g
        Kp = l2 * match * inner
        tot = tot + Kp.sum((-2, -1))
        tot_l = tot_l + Kp_l.sum((-2, -1))
        tot_g = tot_g + Kp_g.sum((-2, -1))
    return tot, tot_l, tot_g


def ssk_cross_plain(s1, s2, lam2, gap, max_subseq: int = 3) -> Triple:
    """Plain version of ``ssk_cross``: 3 × (B, N, M)."""
    match = (s1[:, None, :, None] == s2[None, :, None, :]).to(lam2.dtype)
    return _dp_plain(match, lam2, gap, max_subseq)


def ssk_self_plain(s, lam2, gap, max_subseq: int = 3) -> Triple:
    """Plain version of ``ssk_self``: 3 × (B, N)."""
    match = (s[:, :, None] == s[:, None, :]).to(lam2.dtype)
    return _dp_plain(match, lam2, gap, max_subseq)


def _scan_serial(u, ug, g, p):
    """Exclusive decayed row scan R[b] = Σ_{c<b} u[c]·g^{b−1−c} and its gap
    tangent, one column after another as the kernel runs it; R = 0 at
    b ≤ p − 1."""
    R, Rg = torch.zeros_like(u), torch.zeros_like(u)
    r, rg, g = R[..., 0], Rg[..., 0], g[..., 0]
    for b in range(p, u.shape[-1]):
        rg = g * rg + (ug[..., b - 1] + r)
        r = g * r + u[..., b - 1]
        R[..., b], Rg[..., b] = r, rg
    return R, Rg


def ssk_scan_plain(s1: torch.Tensor, s2: Optional[torch.Tensor], lam2: torch.Tensor,
                   gap: torch.Tensor, max_subseq: int = 3) -> Triple:
    """Kernel K3's recursion in plain torch (used by the tests only): raw
    totals and tangents of all pairs of s1 × s2 (B, N, M), or of the pairs
    (i, i) of s1 when s2 is None (B, N).

    It follows ``csrc/ssk.cu``'s schedule: rows streamed, steps from P down
    to 1, the λ_m²-free chain V_p = m·(DᵀV_{p−1}D) with its gap tangent as
    row scans R and column recursions T, structural zeros (rows and columns
    < p − 1) skipped, and the totals Σ_p λ^p S_p, Σ_p p·λ^{p−1} S_p,
    Σ_p λ^p S′_p.  Every route runs these recursions in this order; S_p is
    summed per column first, as the warp route's lanes keep their shares
    (the other routes sum each row in column order)."""
    P = int(max_subseq)
    if s2 is None:
        match = s1[:, :, None] == s1[:, None, :]
    else:
        match = (s1[:, None, :, None] == s2[None, :, None, :]).flatten(0, 1)
    B, (pairs, L) = lam2.shape[0], match.shape[:2]
    g = gap.reshape(B, 1, 1)
    zero = lam2.new_zeros(())
    tv = lam2.new_zeros((max(P - 1, 1), B, pairs, L))  # T_p[a, ·] for p = 2..P
    tg = torch.zeros_like(tv)
    S = lam2.new_zeros((P, B, pairs, L))  # per column (the warp route's lanes)
    Sg = torch.zeros_like(S)
    for a in range(L):
        m = match[:, a, :]
        for p in range(P, 0, -1):
            if a < p - 1:
                continue  # structural zero row
            if p == 1:
                u, ug = m.to(lam2.dtype).expand(B, -1, -1), torch.zeros_like(tv[0])
            else:
                u, ug = torch.where(m, tv[p - 2], zero), torch.where(m, tg[p - 2], zero)
            S[p - 1] += u
            Sg[p - 1] += ug
            if p < P:
                R, Rg = _scan_serial(u, ug, g, p)
                Tv, Tg = tv[p - 1, ..., p:], tg[p - 1, ..., p:]  # zero at columns < p
                Tg.copy_(g * Tg + (Rg[..., p:] + Tv))
                Tv.copy_(g * Tv + R[..., p:])
    S, Sg = S.sum(-1), Sg.sum(-1)
    tot, totl, totg = (torch.zeros_like(S[0]) for _ in range(3))
    lam = lam2.reshape(B, 1)
    pw = torch.ones_like(lam)  # λ^{p−1}
    for p in range(1, P + 1):
        totl = totl + p * pw * S[p - 1]
        pw = pw * lam
        tot = tot + pw * S[p - 1]
        totg = totg + pw * Sg[p - 1]
    shape = (B, s1.shape[0]) if s2 is None else (B, s1.shape[0], s2.shape[0])
    return tot.reshape(shape), totl.reshape(shape), totg.reshape(shape)


def _codes(s: torch.Tensor) -> torch.Tensor:
    if s.dtype.is_floating_point:
        s = torch.round(s)
    return s.to(torch.int32).contiguous()


def _check(what, s1, s2, lam2, gap):
    native.require_cuda(what, lam2, gap)
    native.require_cuda(what, s1, s2, dtype=torch.int32)
    if s1.device != lam2.device:
        raise ValueError(f"{what}: codes and decays on different devices")
    if s1.dim() != 2 or s2.dim() != 2 or s1.shape[1] != s2.shape[1]:
        raise ValueError(f"{what}: codes {tuple(s1.shape)}, {tuple(s2.shape)} are not (N, L), (M, L)")
    if lam2.dim() != 1 or gap.shape != lam2.shape:
        raise ValueError(f"{what}: lam2 {tuple(lam2.shape)} and gap {tuple(gap.shape)} are not (B,)")


def ssk_cross(s1, s2, lam2, gap, max_subseq: int = 3) -> Triple:
    """Raw SSK totals of all pairs and their two tangents, each (B, N, M).
    Kernel K3 on CUDA (#3), plain version on CPU."""
    if s1.device.type == "cpu":
        return ssk_cross_plain(s1, s2, lam2, gap, max_subseq)
    a, b = _codes(s1), _codes(s2)
    lam2, gap = lam2.contiguous(), gap.contiguous()
    _check("ssk_cross", a, b, lam2, gap)
    B, (N, L), M = lam2.shape[0], a.shape, b.shape[0]
    out = torch.empty((3, B, N, M), dtype=torch.float32, device=a.device)
    lib = native.load("ssk")
    err = native.call(
        lib.hebo_ssk_cross, a.device, a.data_ptr(), b.data_ptr(), lam2.data_ptr(),
        gap.data_ptr(), out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        B, N, M, L, int(max_subseq),
    )
    native.check(err, "ssk_cross")
    ssk_cross.launches += 1
    return out[0], out[1], out[2]


def ssk_self(s, lam2, gap, max_subseq: int = 3) -> Triple:
    """Raw SSK totals of the pairs (i, i) and their tangents, each (B, N).
    Kernel K3 on CUDA (#4), plain version on CPU."""
    if s.device.type == "cpu":
        return ssk_self_plain(s, lam2, gap, max_subseq)
    a = _codes(s)
    lam2, gap = lam2.contiguous(), gap.contiguous()
    _check("ssk_self", a, a, lam2, gap)
    B, (N, L) = lam2.shape[0], a.shape
    out = torch.empty((3, B, N), dtype=torch.float32, device=a.device)
    lib = native.load("ssk")
    err = native.call(
        lib.hebo_ssk_self, a.device, a.data_ptr(), lam2.data_ptr(), gap.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B, N, L, int(max_subseq),
    )
    native.check(err, "ssk_self")
    ssk_self.launches += 1
    return out[0], out[1], out[2]


ssk_cross.launches = ssk_self.launches = 0


def _normalise(cross: Triple, sa: Triple, sb: Triple):
    """K = c/√(a·b) and its tangents (pallas_ssk.py:207-214)."""
    c, cl, cg = cross
    a0, al, ag = (t[:, :, None] for t in sa)
    b0, bl, bg = (t[:, None, :] for t in sb)
    denom = torch.sqrt(torch.clamp(a0 * b0, min=1e-12))
    K = c / denom
    inv_a = 1.0 / torch.clamp(a0, min=1e-12)
    inv_b = 1.0 / torch.clamp(b0, min=1e-12)
    dK_dl = cl / denom - 0.5 * K * (al * inv_a) - 0.5 * K * (bl * inv_b)
    dK_dg = cg / denom - 0.5 * K * (ag * inv_a) - 0.5 * K * (bg * inv_b)
    return K, dK_dl, dK_dg


class _SSKNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s1, s2, lam2, gap, max_subseq: int, cross: Callable, self_: Callable):
        K, dK_dl, dK_dg = _normalise(
            cross(s1, s2, lam2, gap, max_subseq),
            self_(s1, lam2, gap, max_subseq),
            self_(s2, lam2, gap, max_subseq),
        )
        ctx.save_for_backward(dK_dl, dK_dg)
        return K

    @staticmethod
    def backward(ctx, g):
        dK_dl, dK_dg = ctx.saved_tensors
        return (None, None, (g * dK_dl).sum((-2, -1)), (g * dK_dg).sum((-2, -1)),
                None, None, None)


def ssk_gram(s1: torch.Tensor, s2: torch.Tensor, match_decay: torch.Tensor,
             gap_decay: torch.Tensor, max_subseq: int = 3) -> torch.Tensor:
    """Normalised SSK Gram (B, N, M) for codes s1 (N, L), s2 (M, L) and
    decays (B,); differentiable in both decays.  CUDA tensors go through
    kernel K3 (three launches: cross and the two self sets), CPU tensors
    through the plain version."""
    if s1.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssk_gram: unsupported device {s1.device}")
    lam2 = match_decay * match_decay
    return _SSKNorm.apply(s1, s2, lam2, gap_decay, int(max_subseq), ssk_cross, ssk_self)


def ssk_gram_plain(s1: torch.Tensor, s2: torch.Tensor, match_decay: torch.Tensor,
                   gap_decay: torch.Tensor, max_subseq: int = 3) -> torch.Tensor:
    """Plain version of ``ssk_gram`` on any device."""
    lam2 = match_decay * match_decay
    return _SSKNorm.apply(s1, s2, lam2, gap_decay, int(max_subseq),
                          ssk_cross_plain, ssk_self_plain)
