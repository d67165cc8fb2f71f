"""Carry GP hyperparameters and data over from the JAX package.

The inputs are plain dicts of numpy arrays (``{k: np.asarray(v)}`` of a
``hebo_tpu`` ``GPParams`` / ``GPData``), or a fitted ``hebo_tpu`` model
whose named tuples of arrays are read through ``np.asarray``
(``gp_from_jax``, ``model_from_jax``), so this module needs neither JAX
nor the JAX package.  ``model_from_jax`` also carries the random-
decomposition GP (its cliques first, then the GP's state), the SVGP
(``SVGPParams(gp, Z)``; the port rebuilds its cache from them) and the
DKL GP (its packed MLP is ``params.emb``), and hands the other model
families to ``models.convert``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ...utils.device import resolve_device
from .gp import GPCache, GPData, GPParams

__all__ = ["params_from_jax", "data_from_jax", "cache_from_jax", "gp_from_jax", "svgp_from_jax",
           "model_from_jax"]


def params_from_jax(d: Mapping[str, np.ndarray], device="cuda") -> GPParams:
    """``GPParams`` fields (``log_ls``, ``log_sc``, ``log_noise``, ``mean``,
    ``emb``, ``log_wa``, ``log_wb`` and, with heteroscedastic noise,
    ``noise_w``) → the port's batched ``GPParams``; a missing or ``None``
    ``noise_w`` stays ``None``.

    A stacked set (leading restart/sample axis, ``log_sc`` 1-D) keeps its
    axis; a single set (``log_sc`` 0-d) gets a batch axis of 1."""
    device = resolve_device(device)
    single = np.ndim(d["log_sc"]) == 0
    leaves = []
    for f in GPParams._fields:
        if f == "noise_w" and d.get(f) is None:
            leaves.append(None)
            continue
        a = np.array(d[f], dtype=np.float32)
        leaves.append(torch.as_tensor(a[None] if single else a, device=device))
    return GPParams(*leaves)


def data_from_jax(d: Mapping[str, np.ndarray], device="cuda") -> GPData:
    """``GPData`` fields → the port's ``GPData`` on ``device``."""
    device = resolve_device(device)
    f32 = lambda k: torch.as_tensor(np.array(d[k], dtype=np.float32), device=device)
    return GPData(
        X=f32("X"), y=f32("y"),
        mask=torch.as_tensor(np.array(d["mask"], dtype=bool), device=device),
        x_lb=f32("x_lb"), x_span=f32("x_span"), y_mean=f32("y_mean"), y_std=f32("y_std"),
    )


def cache_from_jax(d: Mapping[str, np.ndarray], device="cuda") -> GPCache:
    """``GPCache`` fields (``L``, ``alpha``, ``ok``, ``Wf``; stacked per
    ensemble sample) → the port's ``GPCache`` on ``device``."""
    device = resolve_device(device)
    f32 = lambda k: torch.as_tensor(np.array(d[k], dtype=np.float32), device=device)
    return GPCache(L=f32("L"), alpha=f32("alpha"),
                   ok=torch.as_tensor(np.array(d["ok"], dtype=bool), device=device),
                   Wf=None if d.get("Wf") is None else f32("Wf"))


def _fields(t) -> dict:
    return {k: np.asarray(v) for k, v in t._asdict().items() if v is not None}


def gp_from_jax(jax_gp, port_gp):
    """Copy a fitted ``hebo_tpu`` GP's params, samples, caches and data into
    the port's ``port_gp`` (on its device), which then predicts as the JAX
    one does; returns ``port_gp``."""
    dev = port_gp.device
    port_gp.params = params_from_jax(_fields(jax_gp.params), dev)
    port_gp.samples = params_from_jax(_fields(jax_gp.samples), dev)
    port_gp.caches = cache_from_jax(_fields(jax_gp.caches), dev)
    port_gp.data = data_from_jax(_fields(jax_gp.data), dev)
    port_gp.fit_data = port_gp.data
    return port_gp


def svgp_from_jax(jax_m, port_m):
    """A fitted ``hebo_tpu`` SVGP's (gp, Z) and data into the port's SVGP,
    whose cache is then built from them; returns ``port_m``."""
    from .svgp import SVGPParams

    dev = port_m.device
    Z = torch.as_tensor(np.array(jax_m.params.Z, dtype=np.float32), device=dev)[None]
    port_m.params = SVGPParams(gp=params_from_jax(_fields(jax_m.params.gp), dev), Z=Z)
    port_m.data = data_from_jax(_fields(jax_m.data), dev)
    port_m._cache = port_m.core.svgp_cache(port_m.params, port_m.data)
    return port_m


def model_from_jax(jax_model, port_model):
    """``gp_from_jax`` (``svgp_from_jax`` for an SVGP; a random-decomposition
    GP takes the JAX model's cliques first), member by member for a
    ``MultiTaskModel``; a deep ensemble, EAC ensemble, GBDT or NAP surrogate
    through ``models.convert.family_from_jax``."""
    if not hasattr(port_model, "models") and not hasattr(port_model, "core"):
        from ..convert import family_from_jax

        return family_from_jax(jax_model, port_model)
    if hasattr(port_model, "models"):
        for jm, tm in zip(jax_model.models, port_model.models):
            model_from_jax(jm, tm)
        return port_model
    if hasattr(port_model.core, "num_inducing"):
        return svgp_from_jax(jax_model, port_model)
    if hasattr(port_model, "resample_decomposition"):
        port_model.cliques = [tuple(int(d) for d in c) for c in jax_model.cliques]
        port_model._rebuild_core()
    return gp_from_jax(jax_model, port_model)
