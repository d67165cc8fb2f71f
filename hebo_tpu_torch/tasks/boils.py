"""BOiLS: BO for logic synthesis — session wrappers + sequence task: the port's own copy of ``hebo_tpu/tasks/boils.py`` (host numpy,
the same numbers).

Parity: BOiLS (15,290 LoC): SSK-kernel BO over
synthesis-operator sequences; sessions drive `abc`/`yosys` via subprocess
(core/sessions/).  External EDA binaries are not required, so the
default backend is the in-repo native ``aig_opt`` tool; the session
protocol is tool-agnostic — point ``command_template`` at abc/yosys when
available (e.g. ``abc -c "read {netlist}; {ops}; print_stats"``).

The canonical BOiLS optimizer = ``BO_ALGOS['BOiLS']`` (SSK GP +
interleaved search + trust region) over this task's sequence space.
"""

from __future__ import annotations

import re
from typing import Callable, Optional, Sequence

import numpy as np
import pandas as pd

from ..design_space import DesignSpace
from ..native import aig_opt_path, run_commands
from .eda import OPERATORS, random_aag

__all__ = ["SynthesisSession", "BoilsTask"]


class SynthesisSession:
    """One netlist + one tool; runs operator sequences, parses metrics."""

    def __init__(
        self,
        netlist_path: Optional[str] = None,
        command_template: Optional[str] = None,
        metric_pattern: str = r"size=(\d+) depth=(\d+)",
        n_threads: int = 0,
    ):
        self.netlist = netlist_path or random_aag(seed=0)
        self.command_template = command_template or (
            aig_opt_path() + " {netlist} '{ops}'"
        )
        self.metric_re = re.compile(metric_pattern)
        self.n_threads = n_threads

    def run_sequences(self, op_seqs: Sequence[Sequence[str]]):
        """→ list of (size, depth) or None per sequence."""
        cmds = [
            self.command_template.format(netlist=self.netlist, ops=";".join(seq))
            for seq in op_seqs
        ]
        out = []
        for code, text in run_commands(cmds, n_threads=self.n_threads):
            m = self.metric_re.search(text)
            out.append(
                (int(m.group(1)), int(m.group(2))) if code == 0 and m else None
            )
        return out


class BoilsTask:
    """Minimize the QoR objective  size/size₀ + depth/depth₀  (the BOiLS
    normalized quality-of-result) over operator sequences."""

    def __init__(self, session: Optional[SynthesisSession] = None,
                 seq_len: int = 8, operators: Optional[Sequence[str]] = None):
        self.session = session or SynthesisSession()
        self.seq_len = seq_len
        self.operators = list(operators or OPERATORS)
        base = self.session.run_sequences([[]])[0]
        self._base = base if base else (1, 1)

    @property
    def space(self) -> DesignSpace:
        return DesignSpace([
            {"name": f"op{i}", "type": "cat", "categories": self.operators}
            for i in range(self.seq_len)
        ])

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        seqs = [
            [row[f"op{i}"] for i in range(self.seq_len)]
            for _, row in df.iterrows()
        ]
        res = self.session.run_sequences(seqs)
        s0, d0 = max(self._base[0], 1), max(self._base[1], 1)
        ys = [
            (r[0] / s0 + r[1] / d0) if r is not None else np.inf for r in res
        ]
        return np.asarray(ys, float).reshape(-1, 1)
