"""Task-specific VAE families for latent-space BO (T-LBO task decoders;
port of ``hebo_tpu/latent/decoders.py``).

* ``TopologyVAE``: a Bernoulli conv VAE over (H, W) structure images.  The
  API keeps the JAX package's NHWC images; inside, the convolutions run
  NCHW and the encoder flattens in (H, W, C) order, as flax does.  flax's
  ``Conv(4, stride 2, 'SAME')`` pads asymmetrically on odd sizes (5 pads
  (1, 2)), so the port pads explicitly; flax's ``ConvTranspose(4, stride
  2, 'SAME')`` correlates with its kernel unflipped, which is
  ``conv_transpose2d`` with the kernel flipped in both spatial axes and
  ``padding=1`` (``latent/convert.py`` flips it when carrying weights).
* ``SeqVAE``: a GRU encoder and an autoregressive GRU decoder (token t
  conditioned on z and token t−1; teacher-forced logits for training, a
  greedy rollout of static length for decoding, the first maximal index
  on ties in both packages).  flax's ``GRUCell`` is torch's GRU with no
  recurrent bias on the r and z gates (``FlaxGRU``).
* ``ImageLatentBO``: the topology loop (weighted-retrained conv VAE, GP +
  EI in the latent box, decoded images out).

``train_topology_vae`` and ``train_seq_vae`` are ``n_steps`` Adam steps
(``vae.adam_train``) with fed or drawn reparameterisation normals, on the
device of the params.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ..acq_optimizers.evolution import EvolutionOpt
from ..acquisitions.acq import EI, AcqParams
from ..design_space import DesignSpace
from ..meta.nap import _Dense, _trunc_normal
from ..models import get_model
from ..optimizers.base import timed
from ..utils.device import resolve_device
from ..utils.dtypes import pad_bucket
from .vae import (_as, _device_of, _dtype_of, adam_train, flax_init, init_params, kl_term, metric_loss,
                  rank_weights, sub_params)

__all__ = [
    "TopologyVAE", "train_topology_vae", "topology_encode", "topology_decode",
    "SeqVAE", "train_seq_vae", "seq_encode", "seq_decode", "ImageLatentBO",
]


# ============================================================ topology (conv)
def _same_pad(n: int, k: int = 4, s: int = 2) -> Tuple[int, int]:
    """flax / XLA 'SAME' padding (low, high) of a strided conv on size n."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class ConvEncoder(nn.Module):
    def __init__(self, latent_dim: int, width: int = 16, image_hw: Tuple[int, int] = (40, 40)):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(cin, cout, 4, stride=2)
            for cin, cout in ((1, width), (width, 2 * width), (2 * width, 4 * width)))
        h, w = image_hw
        for _ in range(3):
            h, w = -(-h // 2), -(-w // 2)
        self.mu = _Dense(h * w * 4 * width, latent_dim)
        self.log_sigma = _Dense(h * w * 4 * width, latent_dim)

    def forward(self, x):  # (B, H, W, 1)
        h = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            (t0, t1), (l0, l1) = _same_pad(h.shape[2]), _same_pad(h.shape[3])
            h = F.relu(conv(F.pad(h, (l0, l1, t0, t1))))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # flax's (H, W, C) flatten
        return self.mu(h), torch.clamp(self.log_sigma(h), -6.0, 2.0)


class ConvDecoder(nn.Module):
    def __init__(self, image_hw: Tuple[int, int], width: int = 16, latent_dim: int = 8):
        super().__init__()
        self.image_hw = tuple(image_hw)
        self.width = width
        H, W = self.image_hw
        self.h0, self.w0 = -(-H // 8), -(-W // 8)  # ceil: upsampled size >= H, W, then crop
        self.proj = _Dense(latent_dim, self.h0 * self.w0 * 4 * width)
        self.deconvs = nn.ModuleList(
            nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1)
            for cin, cout in ((4 * width, 2 * width), (2 * width, width), (width, 1)))

    def forward(self, z):
        H, W = self.image_hw
        h = F.relu(self.proj(z)).reshape(-1, self.h0, self.w0, 4 * self.width).permute(0, 3, 1, 2)
        for i, dc in enumerate(self.deconvs):
            h = dc(h)
            if i < 2:
                h = F.relu(h)
        # crop in case H/W are not multiples of 8
        return h[:, :, :H, :W].permute(0, 2, 3, 1)


class TopologyVAE(nn.Module):
    """Bernoulli conv VAE over (H, W) binary/grayscale structure images."""

    def __init__(self, latent_dim: int = 8, image_hw: Tuple[int, int] = (40, 40), width: int = 16,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.latent_dim, self.image_hw = latent_dim, tuple(image_hw)
        self.encoder = ConvEncoder(latent_dim, width, image_hw)
        self.decoder = ConvDecoder(image_hw, width, latent_dim)
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


def train_topology_vae(
    model: TopologyVAE,
    params: dict,
    X,  # (B, H, W, 1) in [0, 1]
    y,  # (B, 1)
    weights,  # (B,)
    n_steps: int = 200,
    beta: float = 1e-2,
    metric_weight: float = 1.0,
    lr: float = 1e-3,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    """Weighted Bernoulli ELBO + latent metric loss; returns (params,
    losses numpy)."""
    dev, dt = _device_of(params), _dtype_of(params)
    X, y, weights = _as(X, dt, dev), _as(y, dt, dev), _as(weights, dt, dev)
    mask = weights > 0

    def loss_fn(p, eps):
        logits, mu, log_sigma = functional_call(model, p, (X, eps))
        rec = torch.sum(F.binary_cross_entropy_with_logits(logits[..., 0], X[..., 0], reduction="none"),
                        (-2, -1))
        return (torch.mean(weights * (rec + beta * kl_term(mu, log_sigma)))
                + metric_weight * metric_loss(mu, y, mask=mask))

    return adam_train(params, loss_fn, n_steps, lr, noise, (len(X), model.latent_dim), generator)


def topology_encode(model: TopologyVAE, params: dict, X) -> np.ndarray:
    with torch.no_grad():
        mu, _ = functional_call(model.encoder, sub_params(params, "encoder"),
                                (_as(X, torch.float32, _device_of(params)),))
    return mu.cpu().numpy()


def topology_decode(model: TopologyVAE, params: dict, Z) -> np.ndarray:
    with torch.no_grad():
        logits = functional_call(model.decoder, sub_params(params, "decoder"),
                                 (_as(Z, torch.float32, _device_of(params)),))
    return torch.sigmoid(logits).cpu().numpy()


# ======================================================= sequences (GRU AR)
class FlaxGRU(nn.Module):
    """flax's ``GRUCell`` run over a (B, T, in) sequence from a (B, H)
    carry: torch's GRU (``torch.gru``; cuDNN on the card) with the
    recurrent biases of the r and z gates fixed at zero, since flax's
    ``hr`` and ``hz`` have none.  Returns (outputs (B, T, H), carry)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(3 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(3 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.zeros(3 * hidden))
        self.bias_hn = nn.Parameter(torch.zeros(hidden))

    def reset(self, generator):
        """flax's GRUCell initializers: lecun-normal input kernels,
        orthogonal recurrent kernels per gate, zero biases."""
        H = self.hidden
        with torch.no_grad():
            _trunc_normal(self.weight_ih, 1.0 / np.sqrt(self.weight_ih.shape[1]), generator)
            for g in range(3):
                nn.init.orthogonal_(self.weight_hh[g * H:(g + 1) * H], generator=generator)
            self.bias_ih.zero_()
            self.bias_hn.zero_()

    def forward(self, x, h0):
        b_hh = torch.cat([self.bias_hn.new_zeros(2 * self.hidden), self.bias_hn])
        # cuDNN warns that swapped-in (functional_call) weights are not one
        # contiguous chunk and copies them, which is what is meant
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message="RNN module weights are not part")
            out, h = torch.gru(x, h0[None], [self.weight_ih, self.weight_hh, self.bias_ih, b_hh],
                               True, 1, 0.0, self.training, False, True)
        return out, h[0]


class SeqEncoder(nn.Module):
    def __init__(self, vocab: int, latent_dim: int, hidden: int = 64):
        super().__init__()
        self.emb = nn.Embedding(vocab, hidden)
        self.gru = FlaxGRU(hidden, hidden)
        self.mu = _Dense(hidden, latent_dim)
        self.log_sigma = _Dense(hidden, latent_dim)

    def forward(self, tokens):  # (B, L) int
        x = self.emb(tokens.long())
        _, carry = self.gru(x, x.new_zeros((x.shape[0], x.shape[2])))
        return self.mu(carry), torch.clamp(self.log_sigma(carry), -6.0, 2.0)


class SeqDecoder(nn.Module):
    """Autoregressive GRU decoder: token t is conditioned on (z, token t-1)
    — the sequential-construction decoding pattern of the reference's
    grammar/junction-tree decoders, with fixed max length."""

    def __init__(self, vocab: int, length: int, hidden: int = 64, latent_dim: int = 8):
        super().__init__()
        self.vocab, self.length = vocab, length
        self.emb = nn.Embedding(vocab + 1, hidden)  # +1 for BOS
        self.gru = FlaxGRU(hidden, hidden)
        self.head = _Dense(hidden, vocab)
        self.z_proj = _Dense(latent_dim, hidden)

    def forward(self, z, tokens: Optional[torch.Tensor] = None):
        """Teacher-forced logits if ``tokens`` given, else greedy rollout."""
        B = z.shape[0]
        z_proj = self.z_proj(z)
        carry = torch.tanh(z_proj)
        bos = torch.full((B, 1), self.vocab, dtype=torch.long, device=z.device)
        if tokens is not None:
            prev = torch.cat([bos, tokens[:, :-1].long()], 1)
            hs, _ = self.gru(self.emb(prev) + z_proj[:, None, :], carry)
            return self.head(hs)  # (B, L, vocab)
        outs, prev = [], bos
        for _t in range(self.length):
            _, carry = self.gru(self.emb(prev) + z_proj[:, None, :], carry)
            prev = torch.argmax(self.head(carry), -1, keepdim=True)
            outs.append(prev)
        return torch.cat(outs, 1)  # (B, L)


class SeqVAE(nn.Module):
    def __init__(self, vocab: int, length: int, latent_dim: int = 8, hidden: int = 64,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.vocab, self.length, self.latent_dim = vocab, length, latent_dim
        self.encoder = SeqEncoder(vocab, latent_dim, hidden)
        self.decoder = SeqDecoder(vocab, length, hidden, latent_dim)
        dev = resolve_device(device)
        self.to(dev)
        flax_init(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, tokens, noise):
        mu, log_sigma = self.encoder(tokens)
        z = mu + torch.exp(log_sigma) * noise
        return self.decoder(z, tokens), mu, log_sigma

    def encode(self, tokens):
        return self.encoder(tokens)

    def decode(self, z):
        return self.decoder(z, None)


def train_seq_vae(
    model: SeqVAE,
    params: dict,
    tokens,  # (B, L) int
    y,
    weights,
    n_steps: int = 200,
    beta: float = 1e-2,
    metric_weight: float = 1.0,
    lr: float = 1e-3,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
):
    dev, dt = _device_of(params), _dtype_of(params)
    tokens = _as(tokens, torch.long, dev)
    y, weights = _as(y, dt, dev), _as(weights, dt, dev)
    mask = weights > 0

    def loss_fn(p, eps):
        logits, mu, log_sigma = functional_call(model, p, (tokens, eps))
        logp = F.log_softmax(logits, -1)
        rec = -torch.sum(torch.gather(logp, -1, tokens[..., None])[..., 0], -1)
        return (torch.mean(weights * (rec + beta * kl_term(mu, log_sigma)))
                + metric_weight * metric_loss(mu, y, mask=mask))

    return adam_train(params, loss_fn, n_steps, lr, noise, (len(tokens), model.latent_dim), generator)


def seq_encode(model: SeqVAE, params: dict, tokens) -> np.ndarray:
    with torch.no_grad():
        mu, _ = functional_call(model.encoder, sub_params(params, "encoder"),
                                (_as(tokens, torch.long, _device_of(params)),))
    return mu.cpu().numpy()


def seq_decode(model: SeqVAE, params: dict, Z) -> np.ndarray:
    with torch.no_grad():
        toks = functional_call(model.decoder, sub_params(params, "decoder"),
                               (_as(Z, torch.float32, _device_of(params)),))
    return toks.cpu().numpy().astype(np.int32)


# ================================================== latent BO over images
class ImageLatentBO:
    """T-LBO topology loop: weighted-retrained conv VAE + GP-EI in the
    latent box; black box scores decoded images (robust_opt_topology.py).

    Ask/tell over images: ``suggest(n) -> (n, H, W, 1) decoded images``,
    ``observe(images, y)``.  The VAE retrains when
    ``_n_suggests % retrain_every == 1``, as in the JAX package (so never
    with ``retrain_every=1``).  Walls per phase: ``retrain_time``,
    ``fit_time``, ``acq_time``, ``decode_time``.
    """

    def __init__(
        self,
        image_hw: Tuple[int, int] = (40, 40),
        latent_dim: int = 8,
        latent_bound: float = 3.0,
        retrain_every: int = 8,
        vae_steps: int = 150,
        model_config: Optional[dict] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.image_hw = tuple(image_hw)
        self.latent_dim = latent_dim
        self.retrain_every = retrain_every
        self.vae_steps = vae_steps
        self.model_config = model_config or {"num_epochs": 30}
        self.vae = TopologyVAE(latent_dim=latent_dim, image_hw=image_hw, seed=seed, device=self.device)
        self.params = init_params(self.vae)
        self._gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self.latent_space = DesignSpace(
            [
                {"name": f"z{i}", "type": "num", "lb": -latent_bound, "ub": latent_bound}
                for i in range(latent_dim)
            ]
        )
        self.X_img: Optional[np.ndarray] = None
        self.y: Optional[np.ndarray] = None
        self.gp = None
        self._evo = None
        self._n_suggests = 0
        self.retrain_time: list = []
        self.fit_time: list = []
        self.acq_time: list = []
        self.decode_time: list = []

    def observe(self, images: np.ndarray, y: np.ndarray):
        images = np.asarray(images, np.float32).reshape((-1,) + self.image_hw + (1,))
        y = np.asarray(y, np.float32).reshape(len(images), 1)
        self.X_img = images if self.X_img is None else np.concatenate([self.X_img, images])
        self.y = y if self.y is None else np.concatenate([self.y, y])

    def _retrain(self):
        ok = np.isfinite(self.y[:, 0])
        Xv, yv = self.X_img[ok], self.y[ok]
        w = rank_weights(yv[:, 0])
        # pad the batch to its bucket with zero-weight rows, as the JAX
        # package does (its one compile per bucket)
        n = len(Xv)
        n_pad = pad_bucket(max(n, 2))
        Xp = np.zeros((n_pad,) + Xv.shape[1:], np.float32)
        yp = np.zeros((n_pad, 1), np.float32)
        wp = np.zeros((n_pad,), np.float32)
        Xp[:n], yp[:n], wp[:n] = Xv, yv, w
        self.params, _ = train_topology_vae(self.vae, self.params, Xp, yp, wp,
                                            n_steps=self.vae_steps, generator=self._gen)

    def suggest(self, n: int = 1) -> np.ndarray:
        self._n_suggests += 1
        n_obs = 0 if self.y is None else len(self.y)
        if n_obs < 2 * self.latent_dim:
            Z = torch.randn((n, self.latent_dim), generator=self._gen, device=self.device)
            return topology_decode(self.vae, self.params, Z)

        if self._n_suggests % self.retrain_every == 1:
            with timed(self.retrain_time, self.device):
                self._retrain()
        ok = np.isfinite(self.y[:, 0])
        with timed(self.fit_time, self.device):
            Z = topology_encode(self.vae, self.params, self.X_img[ok])
            ys = (self.y[ok] - self.y[ok].mean()) / max(float(self.y[ok].std()), 1e-12)
            if self.gp is None:
                self.gp = get_model("gp", self.latent_space, num_out=1, device=self.device,
                                    **self.model_config)
            self.gp.fit(Z, ys)
        with timed(self.acq_time, self.device):
            if self._evo is None:
                self._evo = EvolutionOpt(self.latent_space, EI(), pop=32, iters=24)
            pop_Z, pop_F = self._evo.optimize(
                model=self.gp,
                acq_params=AcqParams(tau=float(np.min(ys))),
                initial_suggest=Z[np.argmin(ys[:, 0])][None, :],
                return_pop=True,
                seed=n_obs,
            )
        with timed(self.decode_time, self.device):
            order = np.argsort(pop_F[:, 0])[:n]
            return topology_decode(self.vae, self.params, pop_Z[order])
