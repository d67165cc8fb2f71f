"""hebo_tpu_torch — the PyTorch / CUDA port of hebo_tpu for NVIDIA H100.

The same ask/tell contract as ``hebo_tpu``; entry points take ``device=``
(default ``"cuda"``; ``"cpu"`` runs the plain PyTorch versions of the
kernels)::

    from hebo_tpu_torch import DesignSpace, HEBO
    space = DesignSpace([{'name': 'x', 'type': 'num', 'lb': -5, 'ub': 5}])
    opt = HEBO(space, device="cuda")
    for _ in range(32):
        rec = opt.suggest(n_suggestions=8)
        opt.observe(rec, objective(rec))
"""

from .design_space import DesignSpace

__version__ = "0.1.0"

__all__ = ["DesignSpace", "HEBO", "BO", "GeneralBO", "CMAES", "Evolution", "NoisyOpt",
           "get_model", "__version__"]


def __getattr__(name):
    # lazy: importing the package loads no model code
    if name in ("HEBO", "BO", "GeneralBO", "CMAES", "Evolution", "NoisyOpt"):
        from . import optimizers

        return getattr(optimizers, name)
    if name == "get_model":
        from .models import get_model

        return get_model
    raise AttributeError(name)
