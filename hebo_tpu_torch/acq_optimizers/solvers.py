"""febo-style solvers: a candidate set, a grid, and multi-start box L-BFGS
(port of ``hebo_tpu/acq_optimizers/solvers.py``).

``candidate_solver`` and ``grid_solver`` minimize over a finite set with
one batched call.  ``multi_start_lbfgs`` runs every start in lockstep, as
the JAX package's ``_lbfgs_batch`` (:112-197) does under ``vmap``: the
two-loop recursion over each start's stored curvature pairs, projected box
steps, and a line search that evaluates all trial steps of all starts as
one batch (T × B rows).  The iteration count is fixed and the loop reads
nothing on the host; the pair update's curvature guard (sᵀy > 1e-10) is a
mask, as in the JAX package.  The gradient is ``torch.autograd``'s, through
whatever ``f`` computes; through a GP posterior on CUDA that is kernel K2's
VJP in the query points.  Each iteration evaluates f and its gradient once
at the accepted point (the JAX package evaluates them again at the start
of the next iteration; the values are the same).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

__all__ = ["candidate_solver", "grid_solver", "multi_start_lbfgs"]

_STEPS = (1.0, 0.3, 0.1, 0.03, 0.01)  # the line search's trial step sizes


def candidate_solver(f: Callable, candidates: np.ndarray) -> Tuple[np.ndarray, float]:
    """Minimize ``f(X) -> (n, 1)`` over a finite candidate set."""
    vals = np.asarray(f(np.asarray(candidates))).ravel()
    i = int(np.argmin(vals))
    return np.asarray(candidates)[i], float(vals[i])


def grid_solver(f: Callable, lb, ub, points_per_dim: int = 25) -> Tuple[np.ndarray, float]:
    """Minimize over the Cartesian grid of ``points_per_dim ** d`` points
    (low-dimensional subdomains only)."""
    axes = [np.linspace(l, u, points_per_dim) for l, u in zip(np.asarray(lb, float),
                                                              np.asarray(ub, float))]
    mesh = np.meshgrid(*axes, indexing="ij")
    return candidate_solver(f, np.stack([m.ravel() for m in mesh], axis=1))


def _value_and_grad(f, args, X):
    with torch.enable_grad():
        Xg = X.detach().requires_grad_(True)
        v = f(args, Xg)[:, 0]
        g, = torch.autograd.grad(v.sum(), Xg)
    return v.detach(), g


def _two_loop(G, S, Y, rho, k: int, m: int):
    """The L-BFGS direction H·g of every start (B, D) from its m stored
    pairs (B, m, D), the newest at slot (k − 1) mod m."""
    n_valid = min(k, m)
    q, alphas = G, [None] * m
    for i in range(n_valid):
        idx = (k - 1 - i) % m
        a = rho[:, idx] * (S[:, idx] * q).sum(-1)
        q = q - a[:, None] * Y[:, idx]
        alphas[i] = a
    newest = (k - 1) % m
    sy = (S[:, newest] * Y[:, newest]).sum(-1)
    yy = (Y[:, newest] * Y[:, newest]).sum(-1)
    gamma = torch.where(yy > 1e-12, sy / yy, torch.ones_like(sy)) if k > 0 else torch.ones_like(sy)
    z = gamma[:, None] * q
    for j in reversed(range(n_valid)):
        idx = (k - 1 - j) % m
        b = rho[:, idx] * (Y[:, idx] * z).sum(-1)
        z = z + (alphas[j] - b)[:, None] * S[:, idx]
    return z


def lbfgs_batch(f, args, X0: torch.Tensor, lb: torch.Tensor, ub: torch.Tensor,
                n_iters: int, history: int):
    """All starts X0 (B, D) in lockstep, ``f(args, X (n, D)) -> (n, 1)``;
    returns the final points (B, D) and their values (B,), on X0's device."""
    B, D = X0.shape
    project = lambda X: torch.minimum(torch.maximum(X, lb), ub)
    steps = torch.as_tensor(_STEPS, dtype=X0.dtype, device=X0.device)[:, None, None]
    S = torch.zeros((B, history, D), dtype=X0.dtype, device=X0.device)
    Y = torch.zeros_like(S)
    rho = torch.zeros((B, history), dtype=X0.dtype, device=X0.device)
    X = project(X0)
    f_cur, G = _value_and_grad(f, args, X)
    for k in range(n_iters):
        Z = _two_loop(G, S, Y, rho, k, history)
        Xs = project(X[None] - steps * Z[None])  # (T, B, D)
        with torch.no_grad():
            fs = f(args, Xs.reshape(-1, D))[:, 0].view(len(_STEPS), B)
        best = torch.argmin(fs, 0)
        Xn = Xs.gather(0, best[None, :, None].expand(1, B, D))[0]
        fn = fs.gather(0, best[None])[0]
        Xn = torch.where((fn < f_cur)[:, None], Xn, X)
        f_new, Gn = _value_and_grad(f, args, Xn)
        s_new, y_new = Xn - X, Gn - G
        sy = (s_new * y_new).sum(-1)
        good = sy > 1e-10
        idx = k % history
        S[:, idx] = torch.where(good[:, None], s_new, S[:, idx])
        Y[:, idx] = torch.where(good[:, None], y_new, Y[:, idx])
        rho[:, idx] = torch.where(good, 1.0 / torch.clamp(sy, min=1e-12), rho[:, idx])
        X, f_cur, G = Xn, f_new, Gn
    return X, f_cur


def multi_start_lbfgs(f: Callable, X0: np.ndarray, lb, ub, n_iters: int = 30, history: int = 8,
                      args=None, device="cuda") -> Tuple[np.ndarray, float]:
    """Minimize from every row of X0 (B, D) within [lb, ub]; returns the
    best final point (D,) and its value.  ``f(X) -> (B, 1)`` on tensors, or
    ``f(args, X) -> (B, 1)`` when ``args`` is given; the starts run on
    ``device``."""
    if args is None:
        f, args = (lambda a, X, _f=f: _f(X)), ()
    dev = torch.device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    Xf, fv = lbfgs_batch(f, args, torch.as_tensor(np.asarray(X0, np.float32), **f32),
                         torch.as_tensor(np.asarray(lb, np.float32), **f32),
                         torch.as_tensor(np.asarray(ub, np.float32), **f32),
                         int(n_iters), int(history))
    i = int(torch.argmin(fv))
    return Xf[i].cpu().numpy(), float(fv[i])
