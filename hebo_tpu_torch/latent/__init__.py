"""Latent-space BO (T-LBO; port of ``hebo_tpu/latent``): the same names as
the JAX package's ``latent/__init__.py``, plus ``convert``'s carriers of
flax parameters."""

from .lbo import LatentSpaceBO
from .vae import VAE, metric_loss, rank_weights, train_vae
from .decoders import (
    ImageLatentBO, SeqVAE, TopologyVAE, seq_decode, seq_encode,
    topology_decode, topology_encode, train_seq_vae, train_topology_vae,
)
from .convert import seq_vae_from_flax, topology_vae_from_flax, vae_from_flax
