"""Deep ensemble surrogate: every member trained in one batched program
(port of ``hebo_tpu/models/nn/deep_ensemble.py``).

E MLPs with a mean and a variance head, trained full-batch on the NLL (or
MSE) with L1 on the weights, a bootstrap count per member and row, and
Thompson sampling by round-robin over the members (``sample_f``).

The member axis leads every weight: w_i (E, d_in, d_out), b_i (E, d_out),
so a forward is one ``torch.baddbmm`` per layer over all members (the JAX
package's ``vmap``), and ``fit`` runs ``num_epochs`` Adam steps
(``models/gp/tree.adam_step``, optax's bias-corrected update) on all
members at once, on the model's device.  The JAX package's loss multiplies
the (N,) bootstrap counts into the (N, 1) per-row loss, which broadcasts
to (N, N): the loss is (Σw)(Σ nll) / max(Σw, 1), so the counts cancel.
The port computes that same value.  The bootstrap counts come from the
same host ``np.random.default_rng(seed)`` stream as in the JAX package; the
initial weights can be fed (``fit(init=)``) or are drawn from the model's
generator with He scaling √(2 / d_in).  ``_featurize`` is a numpy copy of
the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.device import resolve_device
from ..base import BaseModel, register_model
from ..gp.tree import adam_step, tree_leaves, tree_unflatten

__all__ = ["DeepEnsemble", "MLPParams", "init_mlp", "mlp_forward", "ensemble_moments",
           "member_loss"]


class MLPParams(NamedTuple):
    """Weights w_i (E, d_in, d_out) and biases b_i (E, d_out), member first."""

    w: Tuple[torch.Tensor, ...]
    b: Tuple[torch.Tensor, ...]


def init_mlp(E: int, sizes: Sequence[int], generator: Optional[torch.Generator],
             device) -> MLPParams:
    """E members' weights: √(2 / d_in)·N(0, 1), zero biases (deep_ensemble.py:33-41)."""
    f32 = dict(dtype=torch.float32, device=device)
    ws, bs = [], []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        ws.append(float(np.sqrt(2.0 / din)) * torch.randn((E, din, dout), generator=generator, **f32))
        bs.append(torch.zeros((E, dout), **f32))
    return MLPParams(tuple(ws), tuple(bs))


def mlp_forward(p: MLPParams, x: torch.Tensor):
    """x (N, d) or (E, N, d) → (μ, σ²), each (E, N, 1): ReLU hidden layers,
    head (μ, softplus + 1e-6)."""
    E = p.w[0].shape[0]
    h = x.expand(E, *x.shape) if x.dim() == 2 else x
    for i, (w, b) in enumerate(zip(p.w, p.b)):
        h = torch.baddbmm(b[:, None, :], h, w)
        if i < len(p.w) - 1:
            h = torch.relu(h)
    return h[..., :1], F.softplus(h[..., 1:2]) + 1e-6


def ensemble_moments(mus: torch.Tensor, vars_: torch.Tensor):
    """The mixture's (μ, σ²) over the member axis, σ² floored at 1e-8."""
    mu = mus.mean(0)
    return mu, torch.clamp((vars_ + mus ** 2).mean(0) - mu ** 2, min=1e-8)


def member_loss(mu, var, y, w, loss_name: str = "nll"):
    """(E,) losses of (E, N, 1) heads on y (N, 1) with counts w (E, N): the
    JAX package's Σ(w ⊙ nll) over its (N, N) broadcast, (Σw)(Σ nll) / max(Σw, 1)."""
    if loss_name == "nll":
        nll = 0.5 * (torch.log(var) + (y - mu) ** 2 / var)
    else:
        nll = (y - mu) ** 2
    sw = w.sum(-1)
    return sw * nll.sum((-2, -1)) / torch.clamp(sw, min=1.0)


def adam_fit(params, loss_fn, epochs: int, lr: float):
    """``epochs`` Adam steps (optax's) on every leaf of ``params`` (a nested
    tuple of tensors, member axis first); ``loss_fn(params, step)`` returns
    the (E,) member losses, whose sum is differentiated (the members are
    independent).  Returns the final params."""
    leaves = [t.detach().clone() for t in tree_leaves(params)]
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    for step in range(epochs):
        with torch.enable_grad():
            cur = [t.requires_grad_(True) for t in leaves]
            loss = loss_fn(tree_unflatten(params, cur), step).sum()
            grads = torch.autograd.grad(loss, cur)
        new = []
        for i, (t, g) in enumerate(zip(cur, grads)):
            p, mu[i], nu[i] = adam_step(t.detach(), g, mu[i], nu[i], step + 1, lr)
            new.append(p)
        leaves = new
    return tree_unflatten(params, leaves)


@register_model("deep_ensemble")
class DeepEnsemble(BaseModel):
    support_ts = True
    support_grad = True

    def __init__(self, space, num_out=1, device="cuda", **conf):
        super().__init__(space, num_out, **conf)
        assert num_out == 1
        self.device = resolve_device(device)
        self.num_ensembles = conf.get("num_ensembles", 5)
        self.hidden = conf.get("num_hiddens", 64)
        self.num_layers = conf.get("num_layers", 2)
        self.num_epochs = conf.get("num_epochs", 100)
        self.lr = conf.get("lr", 1e-2)
        self.l1 = conf.get("l1", 1e-3)
        self.bootstrap = conf.get("bootstrap", True)
        self.loss_name = conf.get("loss", "nll")  # 'nll' | 'mse'
        self._seed = conf.get("seed", 0)
        self.params = None
        self._x_stats = None
        self._y_stats = None
        self._cols = None

    # ------------------------------------------------------------- features
    def _featurize(self, X: np.ndarray) -> np.ndarray:
        """Numeric cols + one-hot categoricals (reference OneHotTransform,
        models/layers.py:40-60)."""
        space = self.space
        parts = [X[:, space.numeric_dims + space.perm_dims].astype(np.float32)]
        for c in space.cat_dims:
            n = int(space.num_categories[c])
            oh = np.zeros((len(X), n), np.float32)
            oh[np.arange(len(X)), X[:, c].astype(int)] = 1.0
            parts.append(oh)
        return np.concatenate(parts, axis=1)

    def _featurize_t(self, Xs: torch.Tensor) -> torch.Tensor:
        """``_featurize`` on the device: the numerics, then each categorical
        code compared with its levels (an out-of-range code is all zeros,
        as ``jax.nn.one_hot`` gives)."""
        if self._cols is None or self._cols[0].device != Xs.device:
            sp = self.space
            self._cols = (
                torch.as_tensor(list(sp.numeric_dims) + list(sp.perm_dims), dtype=torch.long,
                                device=Xs.device),
                [(c, torch.arange(int(sp.num_categories[c]), device=Xs.device)) for c in sp.cat_dims])
        num, cats = self._cols
        parts = [Xs.index_select(1, num)]
        for c, levels in cats:
            parts.append((Xs[:, c : c + 1].to(torch.int32) == levels).to(Xs.dtype))
        return torch.cat(parts, 1)

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _sizes(self, d: int):
        return [d] + [self.hidden] * self.num_layers + [2]

    def _bootstrap(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self._seed)
        self._seed += 1
        if self.bootstrap:
            return np.stack([np.bincount(rng.integers(0, n, n), minlength=n)
                             for _ in range(self.num_ensembles)]).astype(np.float32)
        return np.ones((self.num_ensembles, n), np.float32)

    def _prepare(self, X, y):
        """Filter, featurize and standardize (deep_ensemble.py:136-144);
        returns (Fs, ys) float32 on the device and the bootstrap counts."""
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64).reshape(len(X), 1)
        ok = np.isfinite(y[:, 0]) & np.all(np.isfinite(X), axis=1)
        X, y = X[ok], y[ok]
        Fe = self._featurize(X)
        mu_x, sd_x = Fe.mean(0), np.maximum(Fe.std(0), 1e-8)
        mu_y, sd_y = float(y.mean()), max(float(y.std()), 1e-8)
        self._x_stats, self._y_stats = (mu_x, sd_x), (mu_y, sd_y)
        w = self._bootstrap(len(Fe))
        return self._f32((Fe - mu_x) / sd_x), self._f32((y - mu_y) / sd_y), self._f32(w)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(self._seed))

    def fit(self, X, y, init: Optional[MLPParams] = None):
        """Fit every member; ``init`` feeds the initial weights (member
        axis first), else they are drawn from a generator seeded by the
        fit's seed (the JAX package's ``PRNGKey(seed)``)."""
        Fs, ys, w = self._prepare(X, y)
        if init is None:
            init = init_mlp(self.num_ensembles, self._sizes(Fs.shape[1]), self._generator(),
                            self.device)
        l1, loss_name = self.l1, self.loss_name

        def loss(p, _step):
            mu, var = mlp_forward(p, Fs)
            reg = sum(wi.abs().sum((-2, -1)) for wi in p.w)
            return member_loss(mu, var, ys, w, loss_name) + l1 * reg

        self.params = adam_fit(init, loss, self.num_epochs, self.lr)
        return self

    def _predict_scaled(self, Fs: torch.Tensor):
        return ensemble_moments(*mlp_forward(self.params, Fs))

    def predict(self, X):
        Fe = self._featurize(np.asarray(X, np.float64))
        (mu_x, sd_x), (mu_y, sd_y) = self._x_stats, self._y_stats
        mu, var = self._predict_scaled(self._f32((Fe - mu_x) / sd_x))
        return mu.cpu().numpy() * sd_y + mu_y, var.cpu().numpy() * sd_y ** 2

    # pure-state protocol for the acquisition loops
    @property
    def state(self):
        (mu_x, sd_x), (mu_y, sd_y) = self._x_stats, self._y_stats
        return (self.params, self._f32(mu_x), self._f32(sd_x), self._f32(mu_y), self._f32(sd_y))

    def predict_pure(self, state, Xs):
        params, mu_x, sd_x, mu_y, sd_y = state
        Fs = (self._featurize_t(Xs) - mu_x) / sd_x
        mu, var = ensemble_moments(*mlp_forward(params, Fs))
        return mu * sd_y + mu_y, var * sd_y ** 2

    def sample_f(self, n_samples: int = 1, seed: int = 0):
        """Thompson sampling: round-robin over the members (reference
        deep_ensemble.py ``sample_f``)."""

        def f(Xq):
            Fe = self._featurize(np.asarray(Xq, np.float64))
            (mu_x, sd_x), (mu_y, sd_y) = self._x_stats, self._y_stats
            mus, _ = mlp_forward(self.params, self._f32((Fe - mu_x) / sd_x))
            idx = [(seed + i) % self.num_ensembles for i in range(n_samples)]
            return mus.cpu().numpy()[idx] * sd_y + mu_y

        return f

    @property
    def noise(self):
        return np.zeros(1)
