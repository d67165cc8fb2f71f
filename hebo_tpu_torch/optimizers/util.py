"""Bayesmark adapter: a Bayesmark ``api_config`` as a DesignSpace (port of
``hebo_tpu/optimizers/util.py``): types real / int / bool / cat with linear,
log or logit spacing.
"""

from __future__ import annotations

from ..design_space import DesignSpace

__all__ = ["parse_space_from_bayesmark"]


def parse_space_from_bayesmark(api_config: dict) -> DesignSpace:
    specs = []
    for name, conf in api_config.items():
        t = conf["type"]
        if t == "bool":
            specs.append({"name": name, "type": "bool"})
        elif t == "cat":
            specs.append({"name": name, "type": "cat", "categories": list(conf["values"])})
        elif t in ("real", "int"):
            space_kind = conf.get("space", "linear")
            lb, ub = conf["range"]
            if t == "int":
                if space_kind == "log":
                    specs.append({"name": name, "type": "pow_int", "lb": lb, "ub": ub})
                else:
                    specs.append({"name": name, "type": "int", "lb": lb, "ub": ub})
            else:
                if space_kind == "log":
                    specs.append({"name": name, "type": "pow", "lb": lb, "ub": ub})
                else:
                    # logit/bilog treated linearly in [lb, ub] (bounded frame)
                    specs.append({"name": name, "type": "num", "lb": lb, "ub": ub})
        else:
            raise ValueError(f"unsupported bayesmark type {t!r}")
    return DesignSpace(specs)
