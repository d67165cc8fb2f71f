"""Checkpoint / resume for ask/tell optimizers (copy of
``hebo_tpu/utils/checkpoint.py``).

Parity: AntBO's checkpoint discipline — pickle the optimizer plus all RNG
states every iteration, ``--resume`` reloads (AntBO/bo/main.py:167-196,
228-229).  The port's state is simpler and *deterministic by
construction*: its ask/tell optimizers are functions of (X, y, seed
counters, TR state) — every draw of a suggest comes from a generator
seeded by the observation count — so save/restore is a small dict of
numpy arrays + scalars, with the JAX package's keys (``X``, ``y``,
``columns``, ``scalars``, ``tr``).  Nothing in it is a tensor, so a
checkpoint written by either package loads into the other's optimizer.

Two additions make a resumed MCBO optimizer draw what an uninterrupted
one would: the surrogate's fit counter (``GP._seed``, which seeds each
``GP.fit``'s draws and advances per fit) rides along as the scalar
``"model._seed"``, and the trust region's sampler state (its numpy
generator's ``bit_generator.state``, a dict of ints, which
``sample_within_tr`` advances) as ``tr["rng_state"]``.  The JAX package's
restore skips both (its optimizer has no attribute ``model._seed``, and it
reads only its own ``tr`` keys); a checkpoint without them restarts the
fit count at 0 and keeps the fresh trust region's generator, as the JAX
package does.  HEBO's fused suggest seeds from the
observation count alone; an optimizer that builds its model lazily (HEBO)
has none to restore into before its first model suggest.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import pandas as pd

__all__ = ["save_optimizer", "load_optimizer", "optimizer_state_dict", "restore_optimizer_state"]

_SCALAR_ATTRS = [
    "_sobol_count",
    "_suggest_count",
    "_seed",
    "rand_sample",
    "n_init",
]
_MODEL_SCALAR_ATTRS = ["_seed"]


def optimizer_state_dict(opt) -> Dict[str, Any]:
    """Extract the resumable state of any AbstractOptimizer subclass."""
    d: Dict[str, Any] = {
        "X": opt.X.to_dict("list"),
        "y": np.asarray(opt.y),
        "columns": list(opt.X.columns),
        "scalars": {k: getattr(opt, k) for k in _SCALAR_ATTRS if hasattr(opt, k)},
    }
    model = getattr(opt, "model", None)
    for k in _MODEL_SCALAR_ATTRS:
        if isinstance(getattr(model, k, None), int):
            d["scalars"][f"model.{k}"] = getattr(model, k)
    tr = getattr(opt, "tr_manager", None)
    if tr is not None:
        d["tr"] = {
            "center": None if tr.center is None else np.asarray(tr.center),
            "radius": getattr(tr, "radius", None),
            "cat_radius": getattr(tr, "cat_radius", None),
            "succ_count": getattr(tr, "succ_count", 0),
            "fail_count": getattr(tr, "fail_count", 0),
            "restart_count": getattr(tr, "restart_count", 0),
            "prev_centers": [np.asarray(c) for c in getattr(tr, "prev_centers", [])],
        }
        if hasattr(tr, "_rng"):
            d["tr"]["rng_state"] = tr._rng.bit_generator.state
    return d


def restore_optimizer_state(opt, d: Dict[str, Any]):
    opt.X = pd.DataFrame(d["X"], columns=d["columns"])
    opt.y = np.asarray(d["y"])
    for k, v in d.get("scalars", {}).items():
        if k.startswith("model."):
            model = getattr(opt, "model", None)
            if model is not None and hasattr(model, k[6:]):
                setattr(model, k[6:], v)
        elif hasattr(opt, k):
            setattr(opt, k, v)
    tr = getattr(opt, "tr_manager", None)
    if tr is not None and "tr" in d:
        td = d["tr"]
        tr.center = None if td["center"] is None else np.asarray(td["center"])
        for k in ("radius", "cat_radius", "succ_count", "fail_count", "restart_count"):
            if td.get(k) is not None and hasattr(tr, k):
                setattr(tr, k, td[k])
        if hasattr(tr, "prev_centers"):
            tr.prev_centers = [np.asarray(c) for c in td.get("prev_centers", [])]
        if td.get("rng_state") is not None and hasattr(tr, "_rng"):
            tr._rng.bit_generator.state = td["rng_state"]
    return opt


def save_optimizer(opt, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(optimizer_state_dict(opt), f)


def load_optimizer(opt, path: str):
    """Restore state into a freshly-constructed optimizer of the same
    config (models refit from data on the next suggest — the optimizer is
    a function of (X, y))."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return restore_optimizer_state(opt, d)
