"""AntBO: constrained combinatorial sequence BO (antibody CDRH3 design).

Port of ``hebo_tpu/optimizers/antbo.py``.  Parity: AntBO
  * ``CASMOPOLITANCat`` (bo/localbo_cat.py:34-441): categorical trust-region
    BO with succ/fail-driven radii, restarts and batch suggestion,
  * ``Optimizer`` wrapper (bo/optimizer.py:36-120): **guided restart** via an
    auxiliary GP over best-per-restart points, optional
    ``table_of_candidates`` restricting suggestions to a fixed library,
  * CDRH3 biophysical constraints (``check_cdr_constraints_all``,
    bo/localbo_utils.py:32-59): max consecutive-repeat run, no
    N-glycosylation motif N-X-{S/T}, bounded net charge, as a constraint
    callback filtering local-search moves,
  * string / transformed-categorical kernels (bo/kernels.py:80,147): the
    GP's cat_kernel modes ``ssk`` (kernel K3 on CUDA) and
    ``transformed_overlap``.

The sequence space is a DesignSpace of L categorical dims over the
alphabet.  Everything here is host numpy around the GP, whose fits and
acquisition evaluations run on ``device`` (default ``"cuda"``).

One deliberate difference: the JAX package's guided restart swallows every
exception of the auxiliary GP (antbo.py:181-187); here nothing is caught, so
a failed kernel build or launch surfaces where it happens.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

from ..acq_optimizers.mcbo_opts import LocalSearchAcqOptimizer, _one_flip_neighbors
from ..design_space import DesignSpace
from ..models import get_model
from ..trust_region.casmo import CasmopolitanTrManager
from ..utils.device import resolve_device
from .bo_builder import ACQ_FUNC_REGISTRY, MCBOptimizer

__all__ = [
    "sequence_space",
    "check_cdr_constraints",
    "ConstrainedLocalSearch",
    "CasmopolitanCat",
    "AntBOOptimizer",
]

AA_ALPHABET = list("ACDEFGHIKLMNPQRSTVWY")
_CHARGE = {"D": -1.0, "E": -1.0, "K": 1.0, "R": 1.0, "H": 0.1}


def sequence_space(length: int, alphabet: Optional[Sequence[str]] = None) -> DesignSpace:
    alphabet = list(alphabet or AA_ALPHABET)
    return DesignSpace(
        [
            {"name": f"p{i}", "type": "cat", "categories": alphabet}
            for i in range(length)
        ]
    )


def check_cdr_constraints(
    seq: str,
    max_repeat: int = 4,
    charge_range=(-2.0, 2.0),
) -> bool:
    """Biophysical developability constraints (localbo_utils.py:32-59):
    bounded consecutive-repeat run, no N-glycosylation motif N-X-{S,T}
    (X ≠ P), net charge within range."""
    run, prev = 1, ""
    for ch in seq:
        run = run + 1 if ch == prev else 1
        if run > max_repeat:
            return False
        prev = ch
    for i in range(len(seq) - 2):
        if seq[i] == "N" and seq[i + 1] != "P" and seq[i + 2] in ("S", "T"):
            return False
    charge = sum(_CHARGE.get(c, 0.0) for c in seq)
    if not (charge_range[0] <= charge <= charge_range[1]):
        return False
    return True


class ConstrainedLocalSearch(LocalSearchAcqOptimizer):
    """Local search whose moves are filtered by a sequence-constraint
    callback and optionally restricted to a candidate table."""

    def __init__(
        self,
        space,
        constraint: Optional[Callable[[str], bool]] = None,
        table_of_candidates: Optional[np.ndarray] = None,
        alphabet: Optional[Sequence[str]] = None,
        **kw,
    ):
        super().__init__(space, **kw)
        self.constraint = constraint
        self.table = table_of_candidates
        self.alphabet = list(alphabet or AA_ALPHABET)

    def _seq_of(self, x: np.ndarray) -> str:
        return "".join(self.alphabet[int(x[c])] for c in self.space.cat_dims)

    def _feasible_rows(self, X: np.ndarray) -> np.ndarray:
        if self.constraint is None:
            return np.ones(len(X), bool)
        return np.asarray([self.constraint(self._seq_of(r)) for r in X])

    def _sample(self, tr, n, seed):
        if self.table is not None:
            rng = np.random.default_rng(seed)
            idx = rng.choice(len(self.table), size=min(n, len(self.table)), replace=False)
            return np.asarray(self.table)[idx].astype(float)
        X = super()._sample(tr, 4 * n, seed)
        ok = self._feasible_rows(X)
        Xok = X[ok]
        if len(Xok) >= n:
            return Xok[:n]
        return np.vstack([Xok, X[~ok][: n - len(Xok)]])

    def optimize(self, model, acq, acq_params, n_suggestions=1, x_observed=None,
                 tr_manager=None, seed=0):
        tr = self._tr(tr_manager)
        cands = self._sample(tr, self.n_random, seed)
        s = self._score(model, acq, acq_params, cands)
        starts = cands[np.argsort(s)[: self.n_starts]].copy()
        best_X, best_s = [], []
        for x in starts:
            x = np.asarray(x, float).copy()
            sx = self._score(model, acq, acq_params, x[None, :])[0]
            for _ in range(self.n_rounds):
                nbs = _one_flip_neighbors(self.space, x)[1:]
                ok = self._feasible_rows(nbs)
                if self.table is not None:
                    tab = {tuple(r) for r in np.asarray(self.table).astype(float).tolist()}
                    ok &= np.asarray([tuple(r.tolist()) in tab for r in nbs])
                nbs = nbs[ok]
                if len(nbs) == 0:
                    break
                sc = self._score(model, acq, acq_params, nbs)
                j = int(np.argmin(sc))
                if sc[j] < sx - 1e-9:
                    x, sx = nbs[j].copy(), sc[j]
                else:
                    break
            best_X.append(x)
            best_s.append(sx)
        return self._top_unique(
            np.stack(best_X), np.asarray(best_s), n_suggestions, x_observed
        )


class CasmopolitanCat(MCBOptimizer):
    """Categorical Casmopolitan core with guided restarts.

    Guided restart (bo/optimizer.py:36-120): when the TR collapses, an
    auxiliary GP is fit on the best point of each finished restart and the
    new center is the max-variance (most informative) candidate."""

    def __init__(self, space, model, acq_func, acq_optimizer, tr_manager,
                 n_init=10, **kw):
        super().__init__(space, model, acq_func, acq_optimizer, tr_manager,
                         n_init=n_init, **kw)
        self.restart_bests: List[np.ndarray] = []
        self.restart_best_ys: List[float] = []

    def method_suggest(self, n_suggestions=1, fix_input=None):
        if self.tr_manager.needs_restart and self.num_obs >= self.n_init:
            Xn = self.space.transform(self.X)
            self.restart_bests.append(Xn[self.best_id])
            self.restart_best_ys.append(self.best_y)
            self._guided_restart()
        return super().method_suggest(n_suggestions, fix_input)

    def _guided_restart(self):
        tr = self.tr_manager
        tr.restart(seed=self.num_obs)
        if len(self.restart_bests) >= 2:
            aux = get_model("gp", self.space, num_out=1, num_epochs=20,
                            cat_kernel="transformed_overlap" if self.space.cat_dims else "embedding",
                            device=self.model.device)
            Xa = np.stack(self.restart_bests)
            ya = np.asarray(self.restart_best_ys).reshape(-1, 1)
            aux.fit(Xa, ya)
            cands = self.space.sobol_sample_opt(128, seed=self.num_obs)
            _, var = aux.predict(cands)
            tr.center = cands[int(np.argmax(var[:, 0]))]


class AntBOOptimizer(CasmopolitanCat):
    """Turnkey AntBO: sequence space + SSK/overlap GP + constrained local
    search + Casmopolitan TR."""

    def __init__(
        self,
        seq_len: int = 11,
        alphabet: Optional[Sequence[str]] = None,
        kernel: str = "transformed_overlap",  # or 'ssk'
        acq: str = "ei",
        n_init: int = 10,
        constraint: Optional[Callable[[str], bool]] = check_cdr_constraints,
        table_of_candidates: Optional[np.ndarray] = None,
        model_kwargs: Optional[dict] = None,
        seed: int = 0,
        device="cuda",
    ):
        space = sequence_space(seq_len, alphabet)
        mk = {"num_epochs": 50, "cat_kernel": kernel, **(model_kwargs or {})}
        model = get_model("gp", space, num_out=1, device=resolve_device(device), **mk)
        acq_func = ACQ_FUNC_REGISTRY[acq]()
        acq_opt = ConstrainedLocalSearch(
            space, constraint=constraint,
            table_of_candidates=table_of_candidates, alphabet=alphabet,
        )
        tr = CasmopolitanTrManager(space, seed=seed)
        super().__init__(space, model, acq_func, acq_opt, tr, n_init=n_init,
                         name="AntBO")
        self.alphabet = list(alphabet or AA_ALPHABET)

    def suggest_sequences(self, n: int = 1) -> List[str]:
        rec = self.suggest(n)
        return [
            "".join(row[f"p{i}"] for i in range(len(self.space.param_order)))
            for _, row in rec.iterrows()
        ]
