"""EDA logic-synthesis sequence-optimization task: the port's own copy of ``hebo_tpu/tasks/eda.py`` (host numpy,
the same numbers).

Parity: MCBO EDA sequence optimization (MCBO/mcbo/tasks/eda_seq_opt/,
1,121-LoC operator lib driving abc/mockturtle binaries via subprocess) and
the MIG task (tasks/mig_seq_opt/).  The black box: given a netlist and a
sequence of synthesis operators, run the logic optimizer and score the
resulting circuit (size + depth).

Here the optimizer binary is the in-repo native ``aig_opt`` tool
(native/src/aig_opt.cpp); evaluations fan out through the native thread
pool (``native.run_commands``).  The search space is a sequence of
categorical operator choices — exactly the reference task shape.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import pandas as pd

from ..design_space import DesignSpace
from ..native import aig_opt_path, run_commands

__all__ = ["EDASeqOptTask", "random_aag", "OPERATORS"]

OPERATORS = ["rw", "b", "dc"]


def random_aag(
    n_inputs: int = 8, n_ands: int = 64, n_outputs: int = 2, seed: int = 0
) -> str:
    """Generate a random latch-free ASCII-AIGER netlist (returns path)."""
    rng = np.random.default_rng(seed)
    lits: List[int] = [2 * (i + 1) for i in range(n_inputs)]
    ands = []
    next_var = n_inputs
    for _ in range(n_ands):
        a = int(lits[rng.integers(len(lits))]) ^ int(rng.integers(2))
        b = int(lits[rng.integers(len(lits))]) ^ int(rng.integers(2))
        next_var += 1
        lhs = 2 * next_var
        ands.append((lhs, a, b))
        lits.append(lhs)
    outs = [int(lits[rng.integers(len(lits))]) for _ in range(n_outputs)]
    path = tempfile.mktemp(suffix=".aag")
    with open(path, "w") as f:
        f.write(f"aag {next_var} {n_inputs} 0 {n_outputs} {len(ands)}\n")
        for i in range(n_inputs):
            f.write(f"{2 * (i + 1)}\n")
        for o in outs:
            f.write(f"{o}\n")
        for lhs, a, b in ands:
            f.write(f"{lhs} {a} {b}\n")
    return path


class EDASeqOptTask:
    """Minimize  size + depth_weight·depth  over operator sequences."""

    def __init__(
        self,
        netlist_path: Optional[str] = None,
        seq_len: int = 6,
        depth_weight: float = 1.0,
        n_threads: int = 0,
    ):
        self.netlist = netlist_path or random_aag(seed=0)
        self.seq_len = seq_len
        self.depth_weight = depth_weight
        self.n_threads = n_threads
        self._exe = aig_opt_path()

    @property
    def space(self) -> DesignSpace:
        return DesignSpace(
            [
                {"name": f"op{i}", "type": "cat", "categories": OPERATORS}
                for i in range(self.seq_len)
            ]
        )

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        cmds = []
        for _, row in df.iterrows():
            seq = ";".join(row[f"op{i}"] for i in range(self.seq_len))
            cmds.append(f"{self._exe} {self.netlist} '{seq}'")
        results = run_commands(cmds, n_threads=self.n_threads)
        ys = []
        for code, out in results:
            m = re.search(r"size=(\d+) depth=(\d+)", out)
            if code != 0 or not m:
                ys.append(np.inf)
            else:
                ys.append(int(m.group(1)) + self.depth_weight * int(m.group(2)))
        return np.asarray(ys, float).reshape(-1, 1)
