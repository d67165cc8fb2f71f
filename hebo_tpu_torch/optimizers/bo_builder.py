"""Mix-and-match BO builder and the named presets (port of
``hebo_tpu/optimizers/bo_builder.py``).

Parity: MCBO ``BoBuilder`` and the BoBase suggest/observe loop
(MCBO/mcbo/optimizers/bo_builder.py:125-583, bo_base.py:71-429): compose
model_id × acq_opt_id × acq_func_id × tr_id into a working optimizer, with
the named presets ``BO_ALGOS`` (Casmopolitan, BOiLS, COMBO, BODi, BOCS,
BOSS, CoCaBO, RDUCB)::

    from hebo_tpu_torch.optimizers.bo_builder import BO_ALGOS, BoBuilder
    opt = BoBuilder(model_id="gp_to", acq_opt_id="is", acq_func_id="ei",
                    tr_id="basic").build_bo(space, n_init=10, device="cuda")
    opt = BO_ALGOS["BOCS"].build_bo(space, n_init=10, device="cuda")

Every id of the JAX package's registries: the models ``gp``, ``gp_o``,
``gp_to``, ``gp_diffusion``, ``gp_hed``, ``gp_ssk``, ``gp_rd``, ``lin_reg``,
``deep_ensemble``, ``rf``, ``svgp``, ``gbdt`` and ``catboost``; the
acquisition optimizers ``is``, ``ls``, ``sa``, ``mab``, ``ga``, ``rs`` and
``mp``; the acquisitions ei, pi, lcb, ucb, ts, mace, cei and addlcb.  Every
preset builds.  ``MCBOptimizer(relearn_every=k)`` resamples a
decomposition model's cliques at every k-th model suggest (RDUCB).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..acq_optimizers.mcbo_opts import (
    GeneticAlgoAcqOptimizer,
    InterleavedSearchAcqOptimizer,
    LocalSearchAcqOptimizer,
    MixedMabAcqOptimizer,
    RandomSearchAcqOptimizer,
    SimulatedAnnealingAcqOptimizer,
)
from ..acq_optimizers.message_passing import MessagePassingOptimizer
from ..acquisitions.acq import CEI, EI, LCB, MACE, PI, AcqParams, AddLCB, ThompsonSampling
from ..models import get_model
from ..trust_region.casmo import CasmopolitanTrManager, ProxyTrManager
from .base import AbstractOptimizer

__all__ = ["BoBuilder", "BO_ALGOS", "MCBOptimizer", "ACQ_FUNC_REGISTRY", "ACQ_OPT_REGISTRY",
           "MODEL_REGISTRY_MAP"]


ACQ_FUNC_REGISTRY = {"ei": EI, "pi": PI, "lcb": LCB, "ucb": LCB, "ts": ThompsonSampling,
                     "mace": MACE, "cei": CEI, "addlcb": AddLCB}

ACQ_OPT_REGISTRY = {
    "is": InterleavedSearchAcqOptimizer,
    "ls": LocalSearchAcqOptimizer,
    "sa": SimulatedAnnealingAcqOptimizer,
    "mab": MixedMabAcqOptimizer,
    "ga": GeneticAlgoAcqOptimizer,
    "rs": RandomSearchAcqOptimizer,
    "mp": MessagePassingOptimizer,
}

# model_id → (get_model name, extra conf)
MODEL_REGISTRY_MAP = {
    "gp": ("gp", {}),
    "gp_o": ("gp", {"cat_kernel": "overlap"}),
    "gp_to": ("gp", {"cat_kernel": "transformed_overlap"}),
    "gp_diffusion": ("gp", {"cat_kernel": "diffusion"}),
    "gp_hed": ("gp", {"cat_kernel": "hed"}),
    "gp_ssk": ("gp", {"cat_kernel": "ssk"}),
    "gp_rd": ("gp_rd", {}),
    "lin_reg": ("lin_reg", {}),
    "deep_ensemble": ("deep_ensemble", {}),
    "rf": ("rf", {}),
    "svgp": ("svgp", {}),
    "gbdt": ("gbdt", {}),
    "catboost": ("catboost", {}),
}


def _lookup(kind: str, registry: dict, key: str):
    if key in registry:
        return registry[key]
    raise ValueError(f"unknown {kind} {key!r}; known: {sorted(registry)}")


class MCBOptimizer(AbstractOptimizer):
    """BoBase-parity loop: rand-init drain → TR restart check → model fit
    → incumbent → TR-restricted acquisition optimization; observe updates
    the TR radii (bo_base.py:209-339).  ``fit_time`` and ``acq_time`` hold
    the seconds of each model fit and acquisition search."""

    support_combinatorial = True
    support_parallel_opt = True

    def __init__(
        self,
        space,
        model,
        acq_func,
        acq_optimizer,
        tr_manager,
        n_init: int = 10,
        kappa: float = 2.0,
        csv_save_path: Optional[str] = None,
        name: str = "MCBO",
        relearn_every: Optional[int] = None,
        batch_strategy: str = "topk",  # 'topk' | 'kb' (Kriging believer)
    ):
        super().__init__(space, csv_save_path)
        self.model = model
        self.acq_func = acq_func
        self.acq_optimizer = acq_optimizer
        self.tr_manager = tr_manager
        self.n_init = n_init
        self.kappa = kappa
        self.name = name
        # RDUCB: resample the random decomposition at every k-th model
        # suggest (learnDependencyStructureRate, RDUCB algorithms.py:266-340)
        self.relearn_every = relearn_every
        # 'kb': batch>1 via Kriging-believer hallucinations — append each
        # suggestion as a fake observation at its posterior mean and refit
        # before the next pick (MCBO utils/model_utils.py:28)
        self.batch_strategy = batch_strategy
        self._suggest_count = 0
        self._sobol_count = 0

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.num_obs < self.n_init:
            X = self.space.sobol_sample_opt(n_suggestions, seed=self._sobol_count)
            self._sobol_count += 1
            return self.space.inverse_transform(X)

        if self.tr_manager.needs_restart:
            self.tr_manager.restart(seed=self.num_obs)

        self._suggest_count += 1
        if (self.relearn_every and hasattr(self.model, "resample_decomposition")
                and self._suggest_count % self.relearn_every == 0):
            self.model.resample_decomposition()

        X = self.space.transform(self.X)
        y = self.y[:, :1].copy()
        ok = np.isfinite(y[:, 0])
        Xv, yv = X[ok], y[ok]
        ys = (yv - yv.mean()) / max(yv.std(), 1e-12)

        t0 = time.time()
        self.model.fit(Xv, ys)
        self.fit_time.append(time.time() - t0)

        best_id = int(np.argmin(ys[:, 0]))
        if self.tr_manager.center is None:
            self.tr_manager.register_center(Xv[best_id])
        # every evaluation of this suggest draws Thompson samples from one
        # seed, as the JAX package's PRNGKey(num_obs)
        params = AcqParams(
            tau=float(ys[best_id, 0]),
            kappa=float(self.kappa),
            noise=math.sqrt(max(float(self.model.noise[0]), 0.0)),
            seed=self.num_obs,
        )
        t0 = time.time()
        if self.batch_strategy == "kb" and n_suggestions > 1:
            recs = []
            X_aug, y_aug = Xv.copy(), ys.copy()
            for j in range(n_suggestions):
                r = self.acq_optimizer.optimize(
                    self.model, self.acq_func, params,
                    n_suggestions=1, x_observed=X_aug,
                    tr_manager=self.tr_manager, seed=self.num_obs + j,
                )
                recs.append(r[0])
                # hallucinate the observation at the posterior mean + refit
                mu_h, _ = self.model.predict(r[:1])
                X_aug = np.vstack([X_aug, r[:1]])
                y_aug = np.vstack([y_aug, mu_h[:, :1]])
                self.model.fit(X_aug, y_aug)
            # restore the model to the real data for the next iteration
            self.model.fit(Xv, ys)
            rec = np.stack(recs)
        else:
            rec = self.acq_optimizer.optimize(
                self.model, self.acq_func, params,
                n_suggestions=n_suggestions,
                x_observed=Xv,
                tr_manager=self.tr_manager,
                seed=self.num_obs,
            )
        self.acq_time.append(time.time() - t0)
        return self.space.inverse_transform(rec)

    def observe_new_data(self, Xdf, y):
        y0 = np.asarray(y[:, 0], float)
        fin = y0[np.isfinite(y0)]
        if len(fin) == 0:
            return
        prev_best = self.best_y if self.num_obs > len(Xdf) else math.inf
        self.tr_manager.adjust(float(np.min(fin)), prev_best)
        # re-center TR on the global incumbent
        Xn = self.space.transform(self.X)
        self.tr_manager.register_center(Xn[self.best_id])


@dataclass
class BoBuilder:
    model_id: str = "gp_to"
    acq_opt_id: str = "is"
    acq_func_id: str = "ei"
    tr_id: Optional[str] = "basic"
    model_kwargs: Dict = field(default_factory=dict)
    acq_opt_kwargs: Dict = field(default_factory=dict)
    tr_kwargs: Dict = field(default_factory=dict)
    name: str = "BO"

    def build_bo(self, search_space, n_init: int = 10, seed: int = 0,
                 device="cuda", **opt_kwargs) -> MCBOptimizer:
        model_name, extra = _lookup("model", MODEL_REGISTRY_MAP, self.model_id)
        acq_cls = _lookup("acq_func", ACQ_FUNC_REGISTRY, self.acq_func_id)
        acq_opt_cls = _lookup("acq_opt", ACQ_OPT_REGISTRY, self.acq_opt_id)
        conf = {**extra, **self.model_kwargs}
        conf.setdefault("num_epochs", 50)
        model = get_model(model_name, search_space, num_out=1, device=device, **conf)
        acq_opt = acq_opt_cls(search_space, **self.acq_opt_kwargs)
        if self.tr_id in (None, "none"):
            tr = ProxyTrManager(search_space)
        else:
            tr = CasmopolitanTrManager(search_space, seed=seed, **self.tr_kwargs)
        return MCBOptimizer(
            search_space, model, acq_cls(), acq_opt, tr,
            n_init=n_init, name=self.name, **opt_kwargs,
        )


# Named presets (MCBO bo_builder.py:574-583)
BO_ALGOS: Dict[str, BoBuilder] = {
    "Casmopolitan": BoBuilder("gp_to", "is", "ei", "basic", name="Casmopolitan"),
    "BOiLS": BoBuilder("gp_ssk", "is", "ei", "basic", name="BOiLS"),
    "COMBO": BoBuilder("gp_diffusion", "ls", "ei", "none", name="COMBO"),
    "BODi": BoBuilder("gp_hed", "is", "ei", "basic", name="BODi"),
    "BOCS": BoBuilder("lin_reg", "sa", "ts", "none", name="BOCS"),
    "BOSS": BoBuilder("gp_ssk", "ga", "ei", "none", name="BOSS"),
    "CoCaBO": BoBuilder("gp_to", "mab", "ei", "none", name="CoCaBO"),
    "RDUCB": BoBuilder("gp_rd", "mp", "lcb", "none", name="RDUCB"),
}
