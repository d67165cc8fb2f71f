"""AntBO black-box tools: Absolut! wrapper, table-filling, manual mode.

Port of ``hebo_tpu/tasks/antbo_tools.py`` (parity: AntBO
``task/tools.py:32-374``), three ways to score CDRH3 sequences:
* ``AbsolutTool`` — drives the external Absolut! binding-energy simulator
  as a subprocess; without the binary, a deterministic surrogate energy
  model with Absolut-like structure keeps the pipeline runnable end to end;
* ``TableFillingTool`` — scores by lookup in a precomputed
  sequence → energy table (AntBO's offline / human-in-the-loop mode);
* ``ManualTool`` — writes the suggested sequences to a file and reads
  scores back, the reference's wet-lab round-trip protocol.

All tools are host-side black boxes.  One deliberate difference: the JAX
package seeds the surrogate from ``hash((antigen, seed))``, which Python
randomises per process (PYTHONHASHSEED), so its objective changes from run
to run; here the seed is a CRC-32 of the antigen name and seed, the same in
every process.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import zlib
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["AbsolutTool", "TableFillingTool", "ManualTool", "AA_ALPHABET"]

AA_ALPHABET = list("ACDEFGHIKLMNPQRSTVWY")


class AbsolutTool:
    """Binding-energy scores for CDRH3 sequences against one antigen.

    With ``absolut_path`` pointing at the Absolut! binary it shells out
    (one batch file per call, ``repertoire`` task, parses the energy
    column).  Without it, a seeded surrogate assigns each (position,
    amino-acid) pair an energy contribution plus sparse pairwise terms —
    deterministic, roughly additive with epistasis, like lattice binding
    models behave.
    """

    def __init__(
        self,
        antigen: str = "1H0D_C",
        absolut_path: Optional[str] = None,
        seq_len: int = 11,
        seed: int = 0,
    ):
        self.antigen = antigen
        self.seq_len = int(seq_len)
        self.absolut_path = absolut_path
        if absolut_path is None or shutil.which(absolut_path) is None:
            self.absolut_path = None
            rng = np.random.default_rng(zlib.crc32(f"{antigen}:{seed}".encode()))
            A = len(AA_ALPHABET)
            self._site = rng.normal(-5.0, 2.0, size=(self.seq_len, A))
            self._pair = rng.normal(0.0, 0.5, size=(self.seq_len, self.seq_len, A, A))
            mask = rng.random((self.seq_len, self.seq_len)) < 0.15
            mask = np.triu(mask, k=1)
            self._pair *= mask[:, :, None, None]
        self._aa_idx = {a: i for i, a in enumerate(AA_ALPHABET)}

    def _surrogate_energy(self, seq: str) -> float:
        idx = [self._aa_idx[a] for a in seq]
        e = float(sum(self._site[i, idx[i]] for i in range(self.seq_len)))
        for i in range(self.seq_len):
            for j in range(i + 1, self.seq_len):
                e += float(self._pair[i, j, idx[i], idx[j]])
        return e

    def _absolut_energies(self, seqs: Sequence[str]) -> List[float]:
        with tempfile.TemporaryDirectory() as d:
            inp = os.path.join(d, "seqs.txt")
            with open(inp, "w") as f:
                for k, s in enumerate(seqs):
                    f.write(f"{k}\t{s}\n")
            subprocess.run(
                [self.absolut_path, "repertoire", self.antigen, inp],
                cwd=d, check=True, capture_output=True,
            )
            out = [p for p in os.listdir(d) if p.endswith("FinalBindings.txt")]
            energies: Dict[str, float] = {}
            with open(os.path.join(d, out[0])) as f:
                for line in f:
                    tok = line.split()
                    if len(tok) >= 3 and tok[1] in set(seqs):
                        try:
                            energies[tok[1]] = float(tok[2])
                        except ValueError:
                            continue
            return [energies.get(s, float("inf")) for s in seqs]

    def __call__(self, seqs: Sequence[str]) -> np.ndarray:
        seqs = [str(s) for s in seqs]
        for s in seqs:
            assert len(s) == self.seq_len, f"sequence length {len(s)} != {self.seq_len}"
        if self.absolut_path is not None:
            vals = self._absolut_energies(seqs)
        else:
            vals = [self._surrogate_energy(s) for s in seqs]
        return np.asarray(vals, float).reshape(-1, 1)


class TableFillingTool:
    """Score by lookup in a precomputed {sequence: energy} table; unseen
    sequences get ``fill_value`` (AntBO's offline table mode)."""

    def __init__(self, table: Dict[str, float], fill_value: float = 0.0):
        self.table = dict(table)
        self.fill_value = float(fill_value)

    def __call__(self, seqs: Sequence[str]) -> np.ndarray:
        return np.asarray(
            [self.table.get(str(s), self.fill_value) for s in seqs], float
        ).reshape(-1, 1)


class ManualTool:
    """Wet-lab round-trip: dump suggestions to ``<dir>/to_score.txt``, read
    scores from ``<dir>/scores.txt`` (one float per line, same order)."""

    def __init__(self, exchange_dir: str):
        self.dir = exchange_dir
        os.makedirs(exchange_dir, exist_ok=True)

    def request(self, seqs: Sequence[str]) -> str:
        path = os.path.join(self.dir, "to_score.txt")
        with open(path, "w") as f:
            f.write("\n".join(str(s) for s in seqs) + "\n")
        return path

    def collect(self, n: int) -> np.ndarray:
        path = os.path.join(self.dir, "scores.txt")
        with open(path) as f:
            vals = [float(line) for line in f if line.strip()]
        assert len(vals) == n, f"expected {n} scores, got {len(vals)}"
        return np.asarray(vals, float).reshape(-1, 1)

    def __call__(self, seqs: Sequence[str]) -> np.ndarray:
        self.request(seqs)
        return self.collect(len(seqs))
