"""EAC ensembles: embedding cells over categorical sequences (port of
``hebo_tpu/models/nn/eac.py``).

Each categorical column is a position; its code looks up a learned
embedding (a gather over the flat offsets, equal to the JAX package's
one-hot contraction), a cell encodes the sequence, and a head gives (μ,
softplus + 1e-6).  The cells (eac.py:55-86):

* ``mlp``: ReLU over the flattened embeddings;
* ``rnn``: the JAX package's own gated recurrence, z = x Wx + h Wh + b split
  into (r, u, n), n = tanh(n·r), h = (1 − u)·n + u·h (not ``torch.nn.GRU``);
* ``transformer``: one block of single-head attention with no mask, a
  residual, a ReLU feed-forward residual, and the mean over positions.

The members train batched (the member axis leads every weight) with Adam on
the NLL; the initial weights can be fed (``fit(init=)``).  Like the JAX
package, the model has no ``state``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.device import resolve_device
from ..base import BaseModel, register_model
from .deep_ensemble import adam_fit, ensemble_moments

__all__ = ["EACEnsemble", "EACParams", "init_cell", "cell_forward"]


class EACParams(NamedTuple):
    emb: torch.Tensor  # (E, total_cats, emb_dim)
    cell: tuple  # cell-specific weights, member first
    head_w: torch.Tensor  # (E, hidden, 2)
    head_b: torch.Tensor  # (E, 2)


def init_cell(cell_type: str, n: int, E: int, L: int, hidden: int, generator, device) -> tuple:
    """n members' cell weights, 0.3·N(0, 1), zero biases (eac.py:34-52)."""
    f32 = dict(dtype=torch.float32, device=device)
    s = lambda *sh: 0.3 * torch.randn((n,) + sh, generator=generator, **f32)  # noqa: E731
    if cell_type == "mlp":
        return (s(L * E, hidden), torch.zeros((n, hidden), **f32))
    if cell_type == "rnn":
        return (s(E, 3 * hidden), s(hidden, 3 * hidden), torch.zeros((n, 3 * hidden), **f32))
    if cell_type == "transformer":
        return (s(E, hidden), s(hidden, hidden), s(hidden, hidden), s(hidden, hidden),
                s(hidden, hidden))
    raise ValueError(cell_type)


def cell_forward(cell_type: str, cw: tuple, emb_seq: torch.Tensor) -> torch.Tensor:
    """emb_seq (E, B, L, emb_dim) → (E, B, hidden)."""
    n, B, L, _ = emb_seq.shape
    if cell_type == "mlp":
        w, b = cw
        return torch.relu(torch.baddbmm(b[:, None, :], emb_seq.reshape(n, B, -1), w))
    if cell_type == "rnn":
        wx, wh, b = cw
        h = emb_seq.new_zeros((n, B, wh.shape[1]))
        xs = emb_seq @ wx[:, None]  # (E, B, L, 3H)
        for t in range(L):
            z = xs[:, :, t] + h @ wh + b[:, None, :]
            r, u, c = torch.chunk(z, 3, dim=-1)
            r, u = torch.sigmoid(r), torch.sigmoid(u)
            c = torch.tanh(c * r)
            h = (1 - u) * c + u * h
        return h
    if cell_type == "transformer":
        win, wq, wk, wv, wf = cw
        h = emb_seq @ win[:, None]  # (E, B, L, H)
        q, k, v = (h @ w[:, None] for w in (wq, wk, wv))
        att = torch.softmax(q @ k.transpose(-1, -2) / float(np.sqrt(1.0 * h.shape[-1])), dim=-1)
        h = h + att @ v
        h = h + torch.relu(h @ wf[:, None])
        return h.mean(2)
    raise ValueError(cell_type)


@register_model("eac")
class EACEnsemble(BaseModel):
    support_ts = True

    def __init__(self, space, num_out=1, device="cuda", **conf):
        super().__init__(space, num_out, **conf)
        assert num_out == 1
        assert space.cat_dims, "EAC expects a (mostly) categorical space"
        self.device = resolve_device(device)
        self.cell_type = conf.get("cell", "mlp")  # mlp | rnn | transformer
        self.E = conf.get("emb_dim", 8)
        self.hidden = conf.get("num_hiddens", 32)
        self.num_ensembles = conf.get("num_ensembles", 4)
        self.num_epochs = conf.get("num_epochs", 100)
        self.lr = conf.get("lr", 1e-2)
        self._seed = conf.get("seed", 0)
        self.L = len(space.cat_dims)
        cats = [int(space.num_categories[c]) for c in space.cat_dims]
        self.total = sum(cats)
        self._offs = np.concatenate([[0], np.cumsum(cats)[:-1]]).astype(np.int64)
        self.params = None
        self._y_stats = (0.0, 1.0)

    def _codes(self, X) -> torch.Tensor:
        """The categorical codes as flat embedding rows (N, L) on the device."""
        codes = np.asarray(X)[:, self.space.cat_dims].astype(np.int64)
        return torch.as_tensor(codes + self._offs[None, :], device=self.device)

    def _forward(self, p: EACParams, flat: torch.Tensor):
        """(μ, σ²), each (E, N, 1), of every member at the flat codes (N, L)."""
        emb_seq = p.emb[:, flat]  # (E, N, L, emb_dim)
        h = cell_forward(self.cell_type, p.cell, emb_seq)
        out = torch.baddbmm(p.head_b[:, None, :], h, p.head_w)
        return out[..., :1], F.softplus(out[..., 1:2]) + 1e-6

    def init_params(self, generator: Optional[torch.Generator] = None) -> EACParams:
        n, f32 = self.num_ensembles, dict(dtype=torch.float32, device=self.device)
        return EACParams(
            emb=0.3 * torch.randn((n, self.total, self.E), generator=generator, **f32),
            cell=init_cell(self.cell_type, n, self.E, self.L, self.hidden, generator, self.device),
            head_w=0.3 * torch.randn((n, self.hidden, 2), generator=generator, **f32),
            head_b=torch.zeros((n, 2), **f32))

    def fit(self, X, y, init: Optional[EACParams] = None):
        """``init`` feeds the members' initial params (member axis first);
        otherwise they are drawn from a generator seeded by the fit's seed."""
        y = np.asarray(y, float).reshape(len(X), 1)
        ok = np.isfinite(y[:, 0])
        flat = self._codes(np.asarray(X)[ok])
        yv = y[ok]
        mu_y, sd_y = float(yv.mean()), max(float(yv.std()), 1e-8)
        self._y_stats = (mu_y, sd_y)
        ys = torch.as_tensor(np.asarray((yv - mu_y) / sd_y, np.float32), device=self.device)
        if init is None:
            init = self.init_params(torch.Generator(device=self.device).manual_seed(int(self._seed)))

        def loss(p, _step):
            mu, var = self._forward(p, flat)
            return (0.5 * (torch.log(var) + (ys - mu) ** 2 / var)).mean((-2, -1))

        self.params = adam_fit(init, loss, self.num_epochs, self.lr)
        self._seed += 1
        return self

    def predict(self, X):
        mu, var = ensemble_moments(*self._forward(self.params, self._codes(X)))
        mu_y, sd_y = self._y_stats
        return mu.cpu().numpy() * sd_y + mu_y, var.cpu().numpy() * sd_y ** 2

    def sample_f(self, n_samples=1, seed=0):
        def f(Xq):
            mus, _ = self._forward(self.params, self._codes(Xq))
            idx = [(seed + i) % self.num_ensembles for i in range(n_samples)]
            mu_y, sd_y = self._y_stats
            return mus.cpu().numpy()[idx] * sd_y + mu_y

        return f
