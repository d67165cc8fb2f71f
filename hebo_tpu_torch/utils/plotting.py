"""Plotting utilities: convergence and regret curves (copy of ``hebo_tpu/utils/plotting.py``).

Parity: MCBO plotting helpers (mcbo/utils/general_plot_utils.py:519) and
RDUCB plot.py — convergence curves with mean ± error bands across seeds.
matplotlib is imported lazily; all functions also return the aggregated
arrays so headless pipelines can skip rendering.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

__all__ = ["best_so_far", "aggregate_curves", "plot_convergence"]


def best_so_far(y: np.ndarray) -> np.ndarray:
    """Running minimum of a (T,) observation sequence (NaN-safe)."""
    y = np.asarray(y, float).copy()
    y[~np.isfinite(y)] = np.inf
    return np.minimum.accumulate(y)


def aggregate_curves(runs: Sequence[np.ndarray]):
    """Stack per-seed best-so-far curves → (mean, stderr) padded to the
    shortest length."""
    T = min(len(r) for r in runs)
    M = np.stack([best_so_far(np.asarray(r)[:T]) for r in runs])
    mean = M.mean(axis=0)
    err = M.std(axis=0) / np.sqrt(len(runs))
    return mean, err


def plot_convergence(
    results: Dict[str, Sequence[np.ndarray]],
    fmin: Optional[float] = None,
    save_path: Optional[str] = None,
    log_regret: bool = False,
):
    """results: method → list of per-seed y sequences.  Returns the
    aggregated dict; renders if matplotlib is available."""
    agg = {name: aggregate_curves(runs) for name, runs in results.items()}
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(6, 4))
        for name, (mean, err) in agg.items():
            x = np.arange(1, len(mean) + 1)
            y = mean - fmin if (fmin is not None and log_regret) else mean
            ax.plot(x, y, label=name)
            ax.fill_between(x, y - err, y + err, alpha=0.25)
        if log_regret:
            ax.set_yscale("log")
            ax.set_ylabel("simple regret")
        else:
            ax.set_ylabel("best objective")
        ax.set_xlabel("evaluations")
        ax.legend()
        fig.tight_layout()
        if save_path:
            fig.savefig(save_path, dpi=120)
        plt.close(fig)
    except Exception:
        pass
    return agg
