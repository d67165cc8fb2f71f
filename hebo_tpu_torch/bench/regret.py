"""Regret of the port's HEBO against the JAX package's recorded curves.

    python3 -m hebo_tpu_torch.bench.regret [--seeds 10] [--iters 16] [--batch 4]
        [--tasks ackley6 branin] [--device cuda] [--out FILE]

The protocol of ``experiments/regret_vs_reference.py``: for each seed,
``HEBO(space, scramble_seed=seed)`` at full defaults, ``iters`` rounds of
``suggest(batch)`` / ``observe``, the incumbent (best y) after each round.
Tasks: Ackley-6D on [-5, 5]⁶ (minimum 0) and Branin on [-5, 10] × [0, 15]
(minimum 0.397887).  The JAX package's side is read from
``experiments/regret_vs_reference.json`` (``jax_curve_mean``, and the final
mean ± 2SE), which that script wrote at 10 seeds × 16 rounds × batch 4; it
records no per-round band, so per round the JAX mean is tested against the
port's ±2SE band, and at the last round the two ±2SE bands are tested for
overlap.  Prints one JSON line per task and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path

import numpy as np

from .. import DesignSpace, HEBO

REPO = Path(__file__).resolve().parents[2]
BRANIN_MIN = 0.397887


def ackley(X):
    X = np.asarray(X, float)
    return (-20.0 * np.exp(-0.2 * np.sqrt((X ** 2).mean(1)))
            - np.exp(np.cos(2 * np.pi * X).mean(1)) + 20.0 + np.e)[:, None]


def branin(X):
    x = np.asarray(X, float)
    b, c, t = 5.1 / (4 * np.pi ** 2), 5.0 / np.pi, 1.0 / (8 * np.pi)
    return ((x[:, 1] - b * x[:, 0] ** 2 + c * x[:, 0] - 6.0) ** 2
            + 10.0 * (1 - t) * np.cos(x[:, 0]) + 10.0)[:, None]


TASKS = {
    "ackley6": ([{"name": f"x{i}", "type": "num", "lb": -5.0, "ub": 5.0} for i in range(6)],
                ackley, 0.0),
    "branin": ([{"name": "x0", "type": "num", "lb": -5.0, "ub": 10.0},
                {"name": "x1", "type": "num", "lb": 0.0, "ub": 15.0}], branin, BRANIN_MIN),
}


def run(task: str, seed: int, iters: int, batch: int, device: str) -> np.ndarray:
    spec, fn, _ = TASKS[task]
    opt = HEBO(DesignSpace(spec), scramble_seed=seed, device=device)
    best = []
    for _ in range(iters):
        rec = opt.suggest(batch)
        opt.observe(rec, fn(rec.values))
        best.append(opt.best_y)
    return np.asarray(best)


def compare(curves: np.ndarray, ref: dict, f_min: float) -> dict:
    """The port's curves (seeds, rounds) against the recorded JAX side."""
    n = len(curves)
    mean = curves.mean(0)
    se2 = 2 * curves.std(0, ddof=1) / math.sqrt(n)
    jmean = np.asarray(ref["jax_curve_mean"])[: curves.shape[1]]
    inside = np.abs(jmean - mean) <= se2
    lo, hi = mean[-1] - se2[-1], mean[-1] + se2[-1]
    jlo, jhi = ref["jax_mean_final"] - ref["jax_2se_final"], ref["jax_mean_final"] + ref["jax_2se_final"]
    return {
        "port_mean_final": float(mean[-1]), "port_2se_final": float(se2[-1]),
        "jax_mean_final": ref["jax_mean_final"], "jax_2se_final": ref["jax_2se_final"],
        "final_bands_overlap": bool(lo <= jhi and jlo <= hi),
        "jax_mean_inside_port_band_frac": float(inside.mean()),
        "jax_mean_inside_port_band": inside.tolist(),
        "port_leq_jax_mean_frac": float((mean <= jmean).mean()),
        "port_regret_final": float(mean[-1] - f_min),
        "port_curve_mean": mean.tolist(), "port_curve_2se": se2.tolist(),
        "jax_curve_mean": jmean.tolist(),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tasks", nargs="+", default=list(TASKS), choices=list(TASKS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="write the results (JSON) here too")
    args = ap.parse_args()
    recorded = json.loads((REPO / "experiments" / "regret_vs_reference.json").read_text())
    results = {}
    for task in args.tasks:
        ref = recorded[task]
        if (ref["seeds"], ref["iters"], ref["batch"]) != (args.seeds, args.iters, args.batch):
            print(f"regret: {task}: the recorded JAX side is {ref['seeds']} seeds × {ref['iters']} "
                  f"rounds × batch {ref['batch']}; this run differs", flush=True)
        t0 = time.time()
        curves = np.stack([run(task, s, args.iters, args.batch, args.device)
                           for s in range(args.seeds)])
        res = {"task": task, "seeds": args.seeds, "iters": args.iters, "batch": args.batch,
               "device": args.device, "wall_s": time.time() - t0,
               **compare(curves[:, : len(ref["jax_curve_mean"])], ref, TASKS[task][2]),
               "port_final_per_seed": curves[:, -1].tolist()}
        if args.device == "cuda":
            import torch
            res["card"] = torch.cuda.get_device_name(0)
        results[task] = res
        print(json.dumps(res), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
