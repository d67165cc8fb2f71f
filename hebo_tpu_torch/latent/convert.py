"""Carry the JAX package's flax VAE parameters into the port's modules.

Each function takes a flax parameter tree (nested dicts of arrays, with or
without the top ``"params"`` level) and returns the port module's
parameter dict on its device, using every flax leaf exactly once
(``meta/nap.py``'s ``_FlaxTree``):
* a Dense kernel (in, out) becomes the transposed Linear weight;
* a Conv kernel (kh, kw, in, out) becomes the (out, in, kh, kw) weight;
* a ConvTranspose kernel (kh, kw, in, out) is flipped in both spatial axes
  and becomes the (in, out, kh, kw) weight (flax correlates with the kernel
  as stored, ``conv_transpose2d`` with it flipped);
* a GRUCell's gates (ir, iz, in with biases; hr, hz without; hn with one)
  become ``weight_ih = [ir; iz; in]ᵀ``, ``bias_ih = [b_ir, b_iz, b_in]``,
  ``weight_hh = [hr; hz; hn]ᵀ`` and ``bias_hn`` (``decoders.FlaxGRU``
  holds the r and z gates' recurrent biases at zero).
"""

from __future__ import annotations

import numpy as np

from ..meta.nap import _FlaxTree

__all__ = ["vae_from_flax", "topology_vae_from_flax", "seq_vae_from_flax"]


def vae_from_flax(flax_params, model) -> dict:
    """``latent/vae.VAE``: encoder Dense_0..3 (two hidden layers, μ, log σ),
    decoder Dense_0, Dense_1 and the output head or one head per column."""
    tree, out = _FlaxTree(flax_params), {}
    for i, name in enumerate(("l0", "l1", "mu", "log_sigma")):
        _dense(tree, out, f"encoder.{name}", "encoder", f"Dense_{i}")
    _dense(tree, out, "decoder.l0", "decoder", "Dense_0")
    _dense(tree, out, "decoder.l1", "decoder", "Dense_1")
    if model.categorical_dims:
        for i in range(len(model.categorical_dims)):
            _dense(tree, out, f"decoder.heads.{i}", "decoder", f"Dense_{2 + i}")
    else:
        _dense(tree, out, "decoder.out", "decoder", "Dense_2")
    return tree.state_dict(out, model)


def topology_vae_from_flax(flax_params, model) -> dict:
    """``latent/decoders.TopologyVAE``: encoder Conv_0..2, Dense_0 (μ),
    Dense_1 (log σ); decoder Dense_0 and ConvTranspose_0..2."""
    tree, out = _FlaxTree(flax_params), {}
    for i in range(3):
        out[f"encoder.convs.{i}.weight"] = tree.take("encoder", f"Conv_{i}", "kernel").transpose(3, 2, 0, 1)
        out[f"encoder.convs.{i}.bias"] = tree.take("encoder", f"Conv_{i}", "bias")
        k = tree.take("decoder", f"ConvTranspose_{i}", "kernel")
        out[f"decoder.deconvs.{i}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
        out[f"decoder.deconvs.{i}.bias"] = tree.take("decoder", f"ConvTranspose_{i}", "bias")
    _dense(tree, out, "encoder.mu", "encoder", "Dense_0")
    _dense(tree, out, "encoder.log_sigma", "encoder", "Dense_1")
    _dense(tree, out, "decoder.proj", "decoder", "Dense_0")
    return tree.state_dict(out, model)


def seq_vae_from_flax(flax_params, model) -> dict:
    """``latent/decoders.SeqVAE``: each side's Embed_0 and GRUCell_0; the
    encoder's Dense_0 (μ) and Dense_1 (log σ); the decoder's Dense_0 (the
    token head) and Dense_1 (the z projection)."""
    tree, out = _FlaxTree(flax_params), {}
    for side in ("encoder", "decoder"):
        out[f"{side}.emb.weight"] = tree.take(side, "Embed_0", "embedding")
        g = lambda gate, leaf: tree.take(side, "GRUCell_0", gate, leaf)
        out[f"{side}.gru.weight_ih"] = np.concatenate([g(k, "kernel") for k in ("ir", "iz", "in")], 1).T
        out[f"{side}.gru.bias_ih"] = np.concatenate([g(k, "bias") for k in ("ir", "iz", "in")])
        out[f"{side}.gru.weight_hh"] = np.concatenate([g(k, "kernel") for k in ("hr", "hz", "hn")], 1).T
        out[f"{side}.gru.bias_hn"] = g("hn", "bias")
    _dense(tree, out, "encoder.mu", "encoder", "Dense_0")
    _dense(tree, out, "encoder.log_sigma", "encoder", "Dense_1")
    _dense(tree, out, "decoder.head", "decoder", "Dense_0")
    _dense(tree, out, "decoder.z_proj", "decoder", "Dense_1")
    return tree.state_dict(out, model)


def _dense(tree: _FlaxTree, out: dict, name: str, *path) -> None:
    out[f"{name}.weight"] = tree.take(*path, "kernel").T
    out[f"{name}.bias"] = tree.take(*path, "bias")
