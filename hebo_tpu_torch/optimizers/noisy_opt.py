"""NoisyOpt: HEBO for noisy objectives (port of
``hebo_tpu/optimizers/noisy_opt.py``).

``NoisyAcq``'s objectives are ``num_samples`` posterior-sample surfaces
μ + σ·ε_k, with one ε (1, num_samples) shared by every candidate and every
generation of a suggest (common random numbers; the JAX package's one key
per suggest, hebo.py:316).  The acquisition declares the normals in
``n_normals``; HEBO draws them with the suggest's other random numbers
(``SuggestDraws``, filled before a captured graph replays) and passes them
in ``AcqParams.draw``, so a MAP GP up to ``max_cholesky_size`` keeps the
fused CUDA graph.
"""

from __future__ import annotations

import torch

from ..acquisitions.acq import Acquisition
from .hebo import HEBO

__all__ = ["NoisyAcq", "NoisyOpt"]


class NoisyAcq(Acquisition):
    """``num_samples`` objectives μ + σ·ε, ε (1, num_samples) from
    ``params.draw`` (without it, from a generator seeded 0, as the JAX
    package's ``PRNGKey(0)``)."""

    def __init__(self, num_samples: int = 3):
        self.num_obj = num_samples
        self.num_constr = 0
        self.n_normals = num_samples

    def eval_pure(self, model, state, params, X):
        mu, var = model.predict_pure(state, X)
        sigma = torch.sqrt(torch.clamp(var, min=1e-12))
        eps = params.draw
        if eps is None:
            gen = torch.Generator(device=mu.device)
            gen.manual_seed(0)
            eps = torch.randn((1, self.num_obj), generator=gen, dtype=mu.dtype, device=mu.device)
        return mu + sigma * eps


class NoisyOpt(HEBO):
    def __init__(self, space, num_samples: int = 3, **kw):
        kw.setdefault("acq_cls", NoisyAcq(num_samples))
        super().__init__(space, **kw)
