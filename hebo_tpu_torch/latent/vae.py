"""Metric-learned VAE for latent-space BO (T-LBO; port of
``hebo_tpu/latent/vae.py``).

* ``VAE``: a Gaussian MLP encoder and an MLP decoder, either continuous
  (squared-error reconstruction) or categorical (one logit head per column,
  the codes read from X); log σ clipped to [−6, 2].
* ``metric_loss``: the soft contrastive loss on latent means, pairs with
  |Δy| < y_eps pulled together and the others pushed beyond a margin.
* ``rank_weights``: w_i ∝ 1 / (k·N + rank_i) for weighted retraining.
* ``train_vae``: ``n_steps`` Adam steps (optax's defaults, the port's
  ``adam_step``) on the weighted ELBO plus the metric loss.

The layers take flax's definitions and initializers (``meta/nap.py``'s
``_Dense``), drawn from a ``torch.Generator`` at construction; a model's
parameters live in a dict that the ``train_*`` functions take and return,
as the JAX package's params pytree (``latent/convert.py`` carries a flax
tree across).  The reparameterisation normals of every step can be fed
(``noise=``); otherwise they come from ``generator``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..meta.nap import _Dense, _trunc_normal
from ..models.gp.tree import adam_train
from ..utils.device import resolve_device

__all__ = ["VAE", "train_vae", "rank_weights", "metric_loss"]


def flax_init(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every layer of ``module`` drawn from ``generator`` with flax's
    defaults: truncated lecun-normal kernels (fan-in: the kernel's input
    width times its window), zero biases, embeddings with std 1/√features,
    a GRU's input kernels lecun-normal and its recurrent kernels
    orthogonal per gate."""
    with torch.no_grad():
        for m in module.modules():
            if hasattr(m, "reset"):  # _Dense, decoders.FlaxGRU
                m.reset(generator)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                cin = m.in_channels if isinstance(m, nn.Conv2d) else m.weight.shape[0]
                _trunc_normal(m.weight, 1.0 / np.sqrt(cin * m.kernel_size[0] * m.kernel_size[1]), generator)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                _trunc_normal(m.weight, 1.0 / np.sqrt(m.embedding_dim), generator)
    return module


def sub_params(params: dict, name: str) -> dict:
    """The entries of a parameter dict under submodule ``name``, unprefixed."""
    pre = name + "."
    return {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}


def init_params(model: nn.Module) -> dict:
    """A detached copy of ``model``'s parameters, the dict the ``train_*``
    functions take."""
    return {k: v.detach().clone() for k, v in model.named_parameters()}


class Encoder(nn.Module):
    def __init__(self, in_dim: int, latent_dim: int, hidden: int = 64):
        super().__init__()
        self.l0, self.l1 = _Dense(in_dim, hidden), _Dense(hidden, hidden)
        self.mu, self.log_sigma = _Dense(hidden, latent_dim), _Dense(hidden, latent_dim)

    def forward(self, x):
        h = F.relu(self.l1(F.relu(self.l0(x))))
        return self.mu(h), torch.clamp(self.log_sigma(h), -6.0, 2.0)


class Decoder(nn.Module):
    def __init__(self, latent_dim: int, out_dim: int, hidden: int = 64,
                 categorical_dims: Tuple[int, ...] = ()):
        super().__init__()
        self.l0, self.l1 = _Dense(latent_dim, hidden), _Dense(hidden, hidden)
        self.categorical_dims = tuple(categorical_dims)
        if self.categorical_dims:
            self.heads = nn.ModuleList(_Dense(hidden, c) for c in self.categorical_dims)
        else:
            self.out = _Dense(hidden, out_dim)

    def forward(self, z):
        h = F.relu(self.l1(F.relu(self.l0(z))))
        if self.categorical_dims:
            return [head(h) for head in self.heads]
        return self.out(h)


class VAE(nn.Module):
    """The JAX package's ``VAE(latent_dim, out_dim, hidden,
    categorical_dims)``: its input width is ``out_dim``."""

    def __init__(self, latent_dim: int, out_dim: int, hidden: int = 64,
                 categorical_dims: Tuple[int, ...] = (), seed: int = 0, device="cuda"):
        super().__init__()
        self.latent_dim, self.out_dim = latent_dim, out_dim
        self.categorical_dims = tuple(categorical_dims)
        self.encoder = Encoder(out_dim, latent_dim, hidden)
        self.decoder = Decoder(latent_dim, out_dim, hidden, self.categorical_dims)
        dev = resolve_device(device)
        self.to(dev)
        flax_init(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, x, noise):
        mu, log_sigma = self.encoder(x)
        z = mu + torch.exp(log_sigma) * noise
        return self.decoder(z), mu, log_sigma

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)


def rank_weights(y: np.ndarray, k: float = 1e-3) -> np.ndarray:
    """w_i ∝ 1 / (k·N + rank_i(y)) — lower y (better) → higher weight."""
    y = np.asarray(y).ravel()
    ranks = np.argsort(np.argsort(y))  # 0 = best (minimization)
    w = 1.0 / (k * len(y) + ranks)
    return w / w.sum() * len(y)


def metric_loss(
    z_mu: torch.Tensor,
    y: torch.Tensor,
    margin: float = 1.0,
    y_eps: float = 0.2,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Soft contrastive loss on latent means: pairs with |Δy| < y_eps are
    positives (pulled), others negatives (pushed beyond margin).  ``mask``
    (B,) excludes padded rows from all pairs."""
    d2 = torch.sum((z_mu[:, None, :] - z_mu[None, :, :]) ** 2, -1)
    d = torch.sqrt(d2 + 1e-9)
    dy = torch.abs(y[:, None, 0] - y[None, :, 0])
    pos = (dy < y_eps).to(z_mu.dtype)
    neg = 1.0 - pos
    if mask is not None:
        m = mask.to(z_mu.dtype)
        pair = m[:, None] * m[None, :]
        pos = pos * pair
        neg = neg * pair
    pos = pos * (1 - torch.eye(len(y), dtype=z_mu.dtype, device=z_mu.device))
    loss_pos = pos * d2
    loss_neg = neg * torch.clamp_min(margin - d, 0.0) ** 2
    denom = torch.clamp_min(torch.sum(pos) + torch.sum(neg), 1.0)
    return (torch.sum(loss_pos) + torch.sum(loss_neg)) / denom


def kl_term(mu: torch.Tensor, log_sigma: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(torch.exp(2 * log_sigma) + mu ** 2 - 1.0 - 2 * log_sigma, -1)


def normals(params: dict, noise: Optional[torch.Tensor], shape: Tuple[int, ...],
            generator: Optional[torch.Generator]) -> Callable[[int], torch.Tensor]:
    """Step ``s``'s reparameterisation normals for ``adam_train``:
    ``noise[s]``, or a fresh draw of ``shape`` from ``generator`` (seeded
    with 0 when None), in the params' float type and on their device."""
    dev, dt = _device_of(params), _dtype_of(params)
    if noise is not None:
        return lambda s: torch.as_tensor(noise[s], dtype=dt, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return lambda s: torch.randn(shape, generator=generator, dtype=dt, device=dev)


def _device_of(params: dict) -> torch.device:
    return next(iter(params.values())).device


def _dtype_of(params: dict) -> torch.dtype:
    """The float type the ``train_*`` functions compute in: the params'
    (float32 as built; float64 when a caller converts the model)."""
    return next(iter(params.values())).dtype


def _as(a, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype, device=dev)


def train_vae(
    model: VAE,
    params: dict,
    X,
    y,
    weights,
    n_steps: int = 200,
    beta: float = 1e-2,
    metric_weight: float = 1.0,
    lr: float = 1e-3,
    labeled=None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Weighted ELBO + metric-loss finetuning on the device of ``params``
    (the model's; ``"cuda"`` by default).

    ``labeled`` (B,) restricts the metric loss to rows with a real
    black-box value — the T-LBO **semi-supervised** mode: the VAE is
    retrained on labeled + unlabeled structures, while value-dependent
    terms see only the labeled subset.  Default: every weighted row.
    ``noise`` (n_steps, B, latent_dim) feeds the reparameterisation
    normals.  Returns (params, losses (n_steps,) numpy)."""
    dev, dt = _device_of(params), _dtype_of(params)
    X, y, weights = _as(X, dt, dev), _as(y, dt, dev), _as(weights, dt, dev)
    metric_mask = weights > 0
    if labeled is not None:
        metric_mask = metric_mask & _as(labeled, torch.bool, dev)
    rows = torch.arange(len(X), device=dev)
    codes = X.long() if model.categorical_dims else None

    def loss_fn(p, eps):
        out, mu, log_sigma = functional_call(model, p, (X, eps))
        if model.categorical_dims:
            rec = 0.0
            for i, logits in enumerate(out):
                rec = rec - F.log_softmax(logits, -1)[rows, codes[:, i]]
        else:
            rec = torch.sum((out - X) ** 2, -1)
        elbo_term = torch.mean(weights * (rec + beta * kl_term(mu, log_sigma)))
        return elbo_term + metric_weight * metric_loss(mu, y, mask=metric_mask)

    return adam_train(params, loss_fn, n_steps, lr,
                      normals(params, noise, (len(X), model.latent_dim), generator))
