"""Carry the non-GP surrogates' fitted state over from the JAX package.

The inputs are the JAX package's named tuples of arrays, read through
``np.asarray`` (no JAX import here): ``ensemble_from_jax`` for a deep
ensemble's ``MLPParams`` or a Gumbel ensemble's ``GumbelParams`` (member
axis first), ``eac_from_jax`` for ``EACParams``, ``gbdt_from_jax`` for a
fitted GBDT (the ``Forest``, the bin edges and the y statistics), and
``family_from_jax`` for a whole fitted model of these families, NAP's
through ``meta.nap.nap_from_flax``.  ``models.gp.model_from_jax``
dispatches here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from .boosting import GBDT, Forest
from .nn.deep_ensemble import DeepEnsemble, MLPParams
from .nn.eac import EACEnsemble, EACParams
from .nn.ensembles_ext import GumbelParams, MCBNEnsemble

__all__ = ["ensemble_from_jax", "eac_from_jax", "gbdt_from_jax", "family_from_jax"]


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def ensemble_from_jax(p, device="cuda"):
    """``MLPParams`` (w, b tuples) or ``GumbelParams`` (mlp, gate_logits)
    → the port's params of the same name on ``device``."""
    device = resolve_device(device)
    if hasattr(p, "gate_logits"):
        return GumbelParams(mlp=ensemble_from_jax(p.mlp, device),
                            gate_logits=_f32(p.gate_logits, device))
    return MLPParams(tuple(_f32(w, device) for w in p.w), tuple(_f32(b, device) for b in p.b))


def eac_from_jax(p, device="cuda") -> EACParams:
    """``EACParams`` (emb, cell tuple, head_w, head_b) → the port's on ``device``."""
    device = resolve_device(device)
    return EACParams(emb=_f32(p.emb, device), cell=tuple(_f32(c, device) for c in p.cell),
                     head_w=_f32(p.head_w, device), head_b=_f32(p.head_b, device))


def gbdt_from_jax(jax_m, port_m: GBDT) -> GBDT:
    """A fitted JAX GBDT's forest, bin edges and y statistics into
    ``port_m``; returns ``port_m``."""
    dev = port_m.device
    f = jax_m.forest
    port_m.forest = Forest(
        feats=torch.as_tensor(np.asarray(f.feats, np.int64), device=dev),
        bins=torch.as_tensor(np.asarray(f.bins, np.int64), device=dev),
        leaf_w=_f32(f.leaf_w, dev))
    port_m._edges = [np.asarray(e, np.float32) for e in jax_m._edges]
    port_m._y_mean, port_m._y_std = float(jax_m._y_mean), float(jax_m._y_std)
    return port_m


def family_from_jax(jax_m, port_m):
    """A fitted JAX deep ensemble (any variant), EAC ensemble, GBDT or NAP
    surrogate into the port's model of the same kind; returns ``port_m``."""
    dev = port_m.device
    if isinstance(port_m, GBDT):
        return gbdt_from_jax(jax_m, port_m)
    if isinstance(port_m, EACEnsemble):
        port_m.params = eac_from_jax(jax_m.params, dev)
        port_m._y_stats = tuple(float(v) for v in jax_m._y_stats)
        return port_m
    if isinstance(port_m, DeepEnsemble):
        port_m.params = ensemble_from_jax(jax_m.params, dev)
        port_m._x_stats = tuple(np.asarray(v, np.float32) for v in jax_m._x_stats)
        port_m._y_stats = tuple(float(v) for v in jax_m._y_stats)
        if isinstance(port_m, MCBNEnsemble):
            port_m._train_F = np.asarray(jax_m._train_F)
        return port_m
    from ..meta.nap import NAPSurrogate, nap_from_flax

    if isinstance(port_m, NAPSurrogate):
        port_m.params = nap_from_flax(jax_m.params, port_m.model)
        Xn, yn, mu_y, sd_y = jax_m._ctx
        port_m._ctx = (np.asarray(Xn, np.float32), np.asarray(yn, np.float32), float(mu_y),
                       float(sd_y))
        return port_m
    raise TypeError(f"no converter for {type(port_m).__name__}")
