"""Unified typed config tree for optimizer construction (port of
``hebo_tpu/config.py``).

The reference's four config styles subsumed into one serializable tree:
  (a) HEBO constructor kwargs / model_config dicts,
  (b) MCBO BoBuilder ids + layered kwargs, including the CLI string form
      ``model__acqopt__acqfunc__tr`` (e.g. ``gp_to__is__ei__basic``),
  (c) RDUCB/AntBO YAML files,
  (d) plain python dicts.

``OptimizerConfig.build(space, device="cuda")`` constructs any of the
port's optimizers on ``device``; ``from_yaml`` / ``to_dict`` round-trip.
The parsing is host code, the same as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .utils.device import resolve_device

__all__ = ["OptimizerConfig", "from_string", "from_yaml", "from_dict"]


_SIMPLE_OPTIMIZERS = {
    "hebo", "bo", "general_bo", "cmaes", "evolution", "noisy_opt", "nomr",
    "random_search", "hill_climbing", "simulated_annealing", "linebo",
    "latent_bo", "antbo",
}
# the baselines that draw on the host only and take no device
_HOST_ONLY = {"random_search", "hill_climbing", "simulated_annealing"}


@dataclass
class OptimizerConfig:
    """Either a named simple optimizer OR a BoBuilder combination."""

    optimizer: str = "hebo"  # simple name, or 'bo_builder'
    # bo_builder fields
    model_id: str = "gp_to"
    acq_opt_id: str = "is"
    acq_func_id: str = "ei"
    tr_id: Optional[str] = "basic"
    n_init: int = 10
    # shared kwargs
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    acq_opt_kwargs: Dict[str, Any] = field(default_factory=dict)
    tr_kwargs: Dict[str, Any] = field(default_factory=dict)
    opt_kwargs: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------- builders
    def build(self, space, device="cuda"):
        """The configured optimizer over ``space``; every optimizer that
        computes on a device gets ``device``."""
        name = self.optimizer.lower()
        dev = resolve_device(device)
        if name == "bo_builder":
            from .optimizers.bo_builder import BoBuilder

            return BoBuilder(
                self.model_id, self.acq_opt_id, self.acq_func_id, self.tr_id,
                model_kwargs=dict(self.model_kwargs),
                acq_opt_kwargs=dict(self.acq_opt_kwargs),
                tr_kwargs=dict(self.tr_kwargs),
            ).build_bo(space, n_init=self.n_init, device=dev, **self.opt_kwargs)
        from . import optimizers as O

        table = {
            "hebo": O.HEBO,
            "bo": O.BO,
            "general_bo": O.GeneralBO,
            "cmaes": O.CMAES,
            "evolution": O.Evolution,
            "noisy_opt": O.NoisyOpt,
            "nomr": O.NoMR_BO,
            "random_search": O.RandomSearch,
            "hill_climbing": O.HillClimbing,
            "simulated_annealing": O.SimulatedAnnealing,
            "linebo": O.LineBO,
        }
        if name == "latent_bo":
            from .latent import LatentSpaceBO

            return LatentSpaceBO(space, device=dev, **self.opt_kwargs)
        if name == "antbo":
            from .optimizers.antbo import AntBOOptimizer

            return AntBOOptimizer(device=dev, **self.opt_kwargs)
        if name not in table:
            raise ValueError(f"unknown optimizer {name!r}")
        kw = dict(self.opt_kwargs)
        if self.model_kwargs and name in ("hebo", "bo", "general_bo",
                                          "noisy_opt", "nomr", "linebo"):
            kw.setdefault("model_config", dict(self.model_kwargs))
        if name not in _HOST_ONLY:
            kw["device"] = dev
        return table[name](space, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def from_dict(d: Dict[str, Any]) -> OptimizerConfig:
    fields = {f.name for f in dataclasses.fields(OptimizerConfig)}
    return OptimizerConfig(**{k: v for k, v in d.items() if k in fields})


def from_string(spec: str, **kw) -> OptimizerConfig:
    """MCBO CLI form: 'model__acqopt__acqfunc__tr' (tr optional)."""
    parts = spec.split("__")
    if len(parts) == 1 and parts[0].lower() in _SIMPLE_OPTIMIZERS:
        return OptimizerConfig(optimizer=parts[0].lower(), **kw)
    if len(parts) == 3:
        model, acqopt, acqfunc = parts
        tr = "none"
    elif len(parts) == 4:
        model, acqopt, acqfunc, tr = parts
    else:
        raise ValueError(f"bad spec {spec!r}")
    return OptimizerConfig(
        optimizer="bo_builder", model_id=model, acq_opt_id=acqopt,
        acq_func_id=acqfunc, tr_id=tr, **kw,
    )


def from_yaml(path: str) -> OptimizerConfig:
    """YAML config file (RDUCB/AntBO style).  Falls back to a minimal
    built-in parser when pyyaml is unavailable (flat key: value pairs +
    one nesting level)."""
    try:
        import yaml

        with open(path) as f:
            d = yaml.safe_load(f)
    except ImportError:
        d = _mini_yaml(path)
    return from_dict(d)


def _mini_yaml(path: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    stack = [out]
    indents = [0]
    for raw in open(path):
        line = raw.rstrip()
        if not line or line.lstrip().startswith("#"):
            continue
        indent = len(line) - len(line.lstrip())
        key, _, val = line.strip().partition(":")
        val = val.strip()
        while indent < indents[-1]:
            stack.pop()
            indents.pop()
        if not val:
            child: Dict[str, Any] = {}
            stack[-1][key] = child
            stack.append(child)
            indents.append(indent + 2)
        else:
            try:
                out_val: Any = json.loads(val)
            except Exception:
                out_val = val
            stack[-1][key] = out_val
    return out
