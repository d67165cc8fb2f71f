"""RDUCB high-dimensional benchmark adapters: NAS-Bench tabular + lpsolve MPS: the port's own copy of ``hebo_tpu/tasks/highdim.py`` (host numpy,
the same numbers).

Parity: RDUCB ``hdbo/datasets.py`` (1,073 LoC) ships four dataset families —
synthetic (we have them in ``tasks/synthetic.py``), LassoBench
(``tasks/lasso.py``), NAS-Bench-101/fcnet tabular HDF5 benchmarks, and
lpsolve MPS mixed-integer programs.  This module covers the last two.

Data files are not shipped with the repository, so each adapter has two modes:
* real mode — point it at the published artifact (fcnet ``.hdf5`` via h5py,
  or an ``.mps`` file) and it evaluates that;
* hermetic mode — a deterministic synthetic instance with the same search
  space and interface, so tests and experiments run offline.

The evaluation is host-side (these are CPU black boxes in the reference
too); the BO loop stays on device.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = ["NASBenchTask", "LPSolveTask", "parse_mps"]


class NASBenchTask:
    """NAS-Bench/fcnet-style tabular architecture benchmark.

    Parity: RDUCB's NAS-Bench-101 (fcnet HDF5) datasets — a purely
    categorical/ordinal config space whose validation error is a lookup.
    With ``hdf5_path`` it reads the fcnet layout (configs JSON-keyed groups
    with ``valid_mse`` datasets, via h5py if importable); otherwise it
    builds a deterministic synthetic table over the same style of space.
    """

    def __init__(
        self,
        hdf5_path: Optional[str] = None,
        n_options: int = 4,
        n_dims: int = 9,
        seed: int = 0,
    ):
        self.n_options = int(n_options)
        self.n_dims = int(n_dims)
        if hdf5_path is not None:
            self._load_hdf5(hdf5_path)
        else:
            rng = np.random.default_rng(seed)
            # low-rank + pairwise interaction surface over the grid: mimics
            # the additive-with-interactions structure RDUCB exploits
            self._main = rng.standard_normal((self.n_dims, self.n_options)) * 0.5
            self._pair = rng.standard_normal(
                (self.n_dims, self.n_dims, self.n_options, self.n_options)
            ) * 0.1
            iu = np.triu_indices(self.n_dims, k=1)
            mask = np.zeros((self.n_dims, self.n_dims), bool)
            mask[iu] = rng.random(len(iu[0])) < 0.25  # sparse interactions
            self._pair *= mask[:, :, None, None]
            self._table = None

    def _load_hdf5(self, path: str):
        import json as _json

        import h5py  # gated: an optional dependency

        X, y = [], []
        with h5py.File(path, "r") as f:
            for key in f.keys():
                cfg = _json.loads(key)
                X.append([cfg[k] for k in sorted(cfg)])
                y.append(float(np.mean(f[key]["valid_mse"][:, -1])))
        self._table = (np.asarray(X, object), np.asarray(y, float))
        self._keys = sorted(cfg)

    @property
    def space(self) -> DesignSpace:
        return DesignSpace([
            {
                "name": f"op{i}",
                "type": "cat",
                "categories": [f"choice{j}" for j in range(self.n_options)],
            }
            for i in range(self.n_dims)
        ])

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        codes = self.space.transform(df).astype(int)
        ys = []
        for row in codes:
            v = float(sum(self._main[i, row[i]] for i in range(self.n_dims)))
            for i in range(self.n_dims):
                for j in range(i + 1, self.n_dims):
                    v += float(self._pair[i, j, row[i], row[j]])
            ys.append(v)
        return np.asarray(ys, float).reshape(-1, 1)


def parse_mps(text: str) -> Dict:
    """Parse the free-format MPS subset (ROWS/COLUMNS/RHS/BOUNDS).

    Returns dict with ``c`` (objective), ``A_ub, b_ub``, ``A_eq, b_eq``,
    ``bounds``, ``names``, ``integer`` (marker-flagged columns).
    """
    rows: Dict[str, str] = {}
    obj_row = None
    col_names: List[str] = []
    col_idx: Dict[str, int] = {}
    entries: List = []  # (row, col, val)
    rhs: Dict[str, float] = {}
    bounds: Dict[str, List[Optional[float]]] = {}
    integer: Dict[str, bool] = {}
    section = None
    int_marker = False
    for raw in text.splitlines():
        if not raw.strip() or raw.startswith("*"):
            continue
        if not raw[0].isspace():
            section = raw.split()[0].upper()
            continue
        tok = raw.split()
        if section == "ROWS":
            sense, name = tok[0].upper(), tok[1]
            if sense == "N" and obj_row is None:
                obj_row = name
            else:
                rows[name] = sense
        elif section == "COLUMNS":
            if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                int_marker = tok[2].upper() == "'INTORG'"
                continue
            col = tok[0]
            if col not in col_idx:
                col_idx[col] = len(col_names)
                col_names.append(col)
                integer[col] = int_marker
            for rname, val in zip(tok[1::2], tok[2::2]):
                entries.append((rname, col, float(val)))
        elif section == "RHS":
            for rname, val in zip(tok[1::2], tok[2::2]):
                rhs[rname] = float(val)
        elif section == "BOUNDS":
            btype, _, col = tok[0].upper(), tok[1], tok[2]
            b = bounds.setdefault(col, [0.0, None])
            if btype == "UP":
                b[1] = float(tok[3])
            elif btype == "LO":
                b[0] = float(tok[3])
            elif btype == "FX":
                b[0] = b[1] = float(tok[3])
            elif btype == "BV":
                b[0], b[1] = 0.0, 1.0
                integer[col] = True
            elif btype == "FR":
                b[0] = None

    n = len(col_names)
    c = np.zeros(n)
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    row_vecs: Dict[str, np.ndarray] = {r: np.zeros(n) for r in rows}
    for rname, col, val in entries:
        j = col_idx[col]
        if rname == obj_row:
            c[j] = val
        elif rname in row_vecs:
            row_vecs[rname][j] = val
    for rname, sense in rows.items():
        b = rhs.get(rname, 0.0)
        if sense == "L":
            A_ub.append(row_vecs[rname]); b_ub.append(b)
        elif sense == "G":
            A_ub.append(-row_vecs[rname]); b_ub.append(-b)
        elif sense == "E":
            A_eq.append(row_vecs[rname]); b_eq.append(b)
    return {
        "c": c,
        "A_ub": np.asarray(A_ub) if A_ub else None,
        "b_ub": np.asarray(b_ub) if b_ub else None,
        "A_eq": np.asarray(A_eq) if A_eq else None,
        "b_eq": np.asarray(b_eq) if b_eq else None,
        "bounds": [tuple(bounds.get(cn, [0.0, None])) for cn in col_names],
        "names": col_names,
        "integer": [integer.get(cn, False) for cn in col_names],
    }


def _random_mip(n_bin: int, n_cont: int, seed: int) -> Dict:
    """Deterministic synthetic MIP instance in parse_mps's output format."""
    rng = np.random.default_rng(seed)
    n = n_bin + n_cont
    c = rng.uniform(-1.0, 1.0, n)
    A_ub = rng.uniform(0.0, 1.0, (max(2, n // 3), n))
    b_ub = A_ub.sum(axis=1) * rng.uniform(0.3, 0.7, len(A_ub))
    return {
        "c": c,
        "A_ub": A_ub,
        "b_ub": b_ub,
        "A_eq": None,
        "b_eq": None,
        "bounds": [(0.0, 1.0)] * n,
        "names": [f"x{i}" for i in range(n)],
        "integer": [True] * n_bin + [False] * n_cont,
    }


class LPSolveTask:
    """BO over the integer variables of a MIP; LP relaxation via scipy.

    Parity: RDUCB lpsolve MPS datasets (hdbo/datasets.py) — the optimizer
    assigns the integer/binary variables; the black box fixes them, solves
    the remaining LP (reference shells out to lpsolve; here
    ``scipy.optimize.linprog``), and returns objective plus an
    infeasibility penalty.
    """

    def __init__(
        self,
        mps_path: Optional[str] = None,
        n_bin: int = 12,
        n_cont: int = 6,
        seed: int = 0,
        infeas_penalty: float = 100.0,
    ):
        if mps_path is not None:
            with open(mps_path) as f:
                self.prob = parse_mps(f.read())
        else:
            self.prob = _random_mip(n_bin, n_cont, seed)
        self.int_idx = [i for i, f in enumerate(self.prob["integer"]) if f]
        self.cont_idx = [i for i, f in enumerate(self.prob["integer"]) if not f]
        self.infeas_penalty = float(infeas_penalty)

    @property
    def space(self) -> DesignSpace:
        specs = []
        for i in self.int_idx:
            lo, hi = self.prob["bounds"][i]
            lo = 0.0 if lo is None else lo
            hi = 1.0 if hi is None else hi
            specs.append({
                "name": self.prob["names"][i],
                "type": "int",
                "lb": int(lo),
                "ub": int(hi),
            })
        return DesignSpace(specs)

    def _solve_one(self, fixed: np.ndarray) -> float:
        from scipy.optimize import linprog

        p = self.prob
        n = len(p["c"])
        x_fix = np.zeros(n)
        x_fix[self.int_idx] = fixed
        if not self.cont_idx:  # pure-integer: evaluate directly
            obj = float(p["c"] @ x_fix)
            viol = 0.0
            if p["A_ub"] is not None:
                viol += float(np.maximum(p["A_ub"] @ x_fix - p["b_ub"], 0).sum())
            if p["A_eq"] is not None:
                viol += float(np.abs(p["A_eq"] @ x_fix - p["b_eq"]).sum())
            return obj + self.infeas_penalty * viol
        ci = np.asarray(self.cont_idx)
        c = p["c"][ci]
        A_ub = b_ub = A_eq = b_eq = None
        if p["A_ub"] is not None:
            A_ub = p["A_ub"][:, ci]
            b_ub = p["b_ub"] - p["A_ub"][:, self.int_idx] @ fixed
        if p["A_eq"] is not None:
            A_eq = p["A_eq"][:, ci]
            b_eq = p["b_eq"] - p["A_eq"][:, self.int_idx] @ fixed
        bounds = [p["bounds"][i] for i in self.cont_idx]
        res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                      bounds=bounds, method="highs")
        base = float(p["c"][self.int_idx] @ fixed)
        if not res.success:
            return base + self.infeas_penalty
        return base + float(res.fun)

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        names = [self.prob["names"][i] for i in self.int_idx]
        ys = [
            self._solve_one(row[names].values.astype(float))
            for _, row in df.iterrows()
        ]
        return np.asarray(ys, float).reshape(-1, 1)
