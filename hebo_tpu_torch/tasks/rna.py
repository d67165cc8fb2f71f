"""RNA inverse folding task: the port's own copy of ``hebo_tpu/tasks/rna.py`` (host numpy,
the same numbers).

Parity: MCBO RNA inverse-fold task (mcbo/tasks/rna_inverse_fold/, which
drives ViennaRNA): design a sequence over {A, C, G, U} whose
minimum-free-energy secondary structure matches a target dot-bracket
structure.  ViennaRNA is not required, so folding uses an
in-repo Nussinov-style dynamic program (maximum weighted base pairing
with a minimum loop length), and the objective is the Hamming distance
between the folded structure and the target (0 = solved).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import pandas as pd

from ..design_space import DesignSpace

__all__ = ["nussinov_fold", "structure_distance", "RNAInverseFoldTask"]

_BASES = ["A", "C", "G", "U"]
_PAIR_SCORE = {
    ("A", "U"): 2.0, ("U", "A"): 2.0,
    ("G", "C"): 3.0, ("C", "G"): 3.0,
    ("G", "U"): 1.0, ("U", "G"): 1.0,
}


def nussinov_fold(seq: str, min_loop: int = 3) -> str:
    """Maximum-weight non-crossing pairing → dot-bracket string."""
    n = len(seq)
    M = np.zeros((n, n))
    for span in range(min_loop + 1, n):
        for i in range(n - span):
            j = i + span
            best = M[i + 1, j]  # i unpaired
            pair = _PAIR_SCORE.get((seq[i], seq[j]), None)
            if pair is not None:
                best = max(best, (M[i + 1, j - 1] if j - 1 >= i + 1 else 0.0) + pair)
            for k in range(i + 1, j):
                best = max(best, M[i, k] + M[k + 1, j])
            M[i, j] = best
    # traceback
    struct = ["."] * n
    stack: List[Tuple[int, int]] = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if i >= j:
            continue
        if M[i, j] == M[i + 1, j]:
            stack.append((i + 1, j))
            continue
        pair = _PAIR_SCORE.get((seq[i], seq[j]), None)
        if pair is not None and abs(
            M[i, j] - ((M[i + 1, j - 1] if j - 1 >= i + 1 else 0.0) + pair)
        ) < 1e-9 and j - i > min_loop:
            struct[i], struct[j] = "(", ")"
            stack.append((i + 1, j - 1))
            continue
        done = False
        for k in range(i + 1, j):
            if abs(M[i, j] - (M[i, k] + M[k + 1, j])) < 1e-9:
                stack.append((i, k))
                stack.append((k + 1, j))
                done = True
                break
        if not done:
            stack.append((i + 1, j))
    return "".join(struct)


def structure_distance(s1: str, s2: str) -> int:
    assert len(s1) == len(s2)
    return sum(a != b for a, b in zip(s1, s2))


class RNAInverseFoldTask:
    def __init__(self, target: str = "((((...))))", min_loop: int = 3):
        self.target = target
        self.min_loop = min_loop
        self.length = len(target)

    @property
    def space(self) -> DesignSpace:
        return DesignSpace([
            {"name": f"b{i}", "type": "cat", "categories": _BASES}
            for i in range(self.length)
        ])

    def sequence_of(self, row) -> str:
        return "".join(row[f"b{i}"] for i in range(self.length))

    def __call__(self, df: pd.DataFrame) -> np.ndarray:
        ys = []
        for _, row in df.iterrows():
            seq = self.sequence_of(row)
            folded = nussinov_fold(seq, self.min_loop)
            ys.append(structure_distance(folded, self.target))
        return np.asarray(ys, float).reshape(-1, 1)
