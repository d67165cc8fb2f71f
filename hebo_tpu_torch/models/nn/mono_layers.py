"""Monotone network layers: lattice interpolation and a constrained MLP
(port of ``hebo_tpu/models/nn/mono_layers.py``).

* ``Lattice1D``: a piecewise-linear calibration on [0, 1] whose knots are
  cumulative softplus increments, so it is non-decreasing by construction;
* ``MonotoneMLP``: softplus-positive weights on the inputs flagged
  monotone (all weights of the deeper layers), tanh between layers, so the
  output is non-decreasing in those inputs.

Both are named tuples of their parameters with a ``__call__``; ``init``
draws from a ``torch.Generator`` or takes the draws (``normals=``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["Lattice1D", "MonotoneMLP"]


class Lattice1D(NamedTuple):
    """Piecewise-linear monotone calibration on [0, 1]."""

    deltas: torch.Tensor  # (K,) unconstrained; softplus → increments
    bias: torch.Tensor  # ()

    @staticmethod
    def init(n_knots: int = 16, device="cuda") -> "Lattice1D":
        return Lattice1D(deltas=torch.zeros((n_knots,), device=device),
                         bias=torch.zeros((), device=device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., 1) in [0, 1] → monotone output (..., 1)."""
        K = self.deltas.shape[0]
        inc = F.softplus(self.deltas)  # ≥ 0 increments
        knots = torch.cat([inc.new_zeros(1), torch.cumsum(inc, 0)])  # (K + 1,)
        t = torch.clamp(x[..., 0], 0.0, 1.0) * K
        i = torch.clamp(t.to(torch.int32), 0, K - 1).long()
        frac = t - i
        y = knots[i] * (1 - frac) + knots[i + 1] * frac
        return (self.bias + y)[..., None]


class MonotoneMLP(NamedTuple):
    ws: Tuple[torch.Tensor, ...]
    bs: Tuple[torch.Tensor, ...]
    mono_mask: torch.Tensor  # (D,) 1 = monotone input

    @staticmethod
    def init(d_in: int, mono_mask, hidden: int = 16, n_layers: int = 2,
             generator: Optional[torch.Generator] = None,
             normals: Optional[Sequence[torch.Tensor]] = None, device="cuda") -> "MonotoneMLP":
        """Weights 0.5·N(0, 1) (``normals`` feeds the standard normals, one
        (a, b) array per layer), zero biases."""
        sizes = [d_in] + [hidden] * n_layers + [1]
        ws, bs = [], []
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            z = (torch.randn((a, b), generator=generator, device=device) if normals is None
                 else torch.as_tensor(normals[i], dtype=torch.float32, device=device))
            ws.append(0.5 * z)
            bs.append(torch.zeros((b,), device=device))
        return MonotoneMLP(tuple(ws), tuple(bs),
                           torch.as_tensor(mono_mask, dtype=torch.float32, device=device))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i, (w, b) in enumerate(zip(self.ws, self.bs)):
            if i == 0:
                # first layer: positive weights on monotone inputs only
                m = self.mono_mask[:, None]
                w_eff = m * F.softplus(w) + (1 - m) * w
            else:
                w_eff = F.softplus(w)  # deeper layers all positive
            h = h @ w_eff + b
            if i < len(self.ws) - 1:
                h = torch.tanh(h)
        return h
