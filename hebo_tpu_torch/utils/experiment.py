"""Experiment runner: task × optimizer → per-eval results frame (port of
``hebo_tpu/utils/experiment.py``).

Parity: MCBO ``run_experiment`` (MCBO/mcbo/utils/experiment_utils.py:308)
and the RDUCB/AntBO experiment runners — budgeted ask/tell loop with
timing, logging, and optional checkpointing each iteration.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from .checkpoint import save_optimizer
from .results_logger import ResultsLogger

__all__ = ["run_experiment", "BOExperiments"]


def run_experiment(
    task: Callable,
    optimizer,
    max_evals: int = 64,
    batch: int = 4,
    save_path: Optional[str] = None,
    checkpoint_path: Optional[str] = None,
    verbose: bool = False,
    stopping_y: Optional[float] = None,
) -> ResultsLogger:
    """The budgeted ask/tell loop.

    ``stopping_y``: RDUCB ``BOStopper`` semantics (reference
    RDUCB/hdbo/myBOModular.py:17-80 — the loop terminates as soon as the
    incumbent reaches the target value) — stop early once
    best-y ≤ stopping_y."""
    logger = ResultsLogger(save_path=save_path)
    while len(logger.rows) < max_evals:
        if stopping_y is not None and logger._best <= stopping_y:
            break
        n = min(batch, max_evals - len(logger.rows))
        t0 = time.time()
        rec = optimizer.suggest(n)
        t_sug = time.time() - t0
        t0 = time.time()
        y = np.asarray(task(rec), float).reshape(len(rec), -1)
        t_eval = time.time() - t0
        t0 = time.time()
        optimizer.observe(rec, y)
        t_obs = time.time() - t0
        logger.append(
            y[:, 0], suggest_time=t_sug, observe_time=t_obs, eval_time=t_eval
        )
        if checkpoint_path:
            save_optimizer(optimizer, checkpoint_path)
        if verbose:
            print(
                f"evals={len(logger.rows)} best={logger._best:.4f} "
                f"suggest={t_sug:.2f}s"
            )
    return logger


class BOExperiments:
    """Config-driven experiment with per-iteration checkpoint + resume.

    Parity: AntBO ``BOExperiments`` (bo/main.py:43-386, save/load 167-196):
    a YAML/dict-configured run that checkpoints the optimizer state every
    iteration and ``resume=True`` picks up where it left off.  State here
    is the host (X, y, seed counters, TR) dict of ``utils.checkpoint``:
    generators seeded by the observation count replace the reference's
    pickled torch/np/random RNG triple.  The optimizer is built on
    ``device`` by ``config.OptimizerConfig.build``.
    """

    def __init__(self, config, task: Callable, space=None, save_dir: str = ".",
                 device="cuda"):
        import os

        from ..config import OptimizerConfig, from_dict, from_string

        if isinstance(config, str):
            cfg = from_string(config)
        elif isinstance(config, dict):
            cfg = from_dict(config)
        elif isinstance(config, OptimizerConfig):
            cfg = config
        else:
            raise TypeError(f"config: {type(config)}")
        self.config = cfg
        self.task = task
        self.space = space if space is not None else task.space
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        self.ckpt_path = os.path.join(save_dir, "optimizer.ckpt")
        self.csv_path = os.path.join(save_dir, "results.csv")
        self.optimizer = cfg.build(self.space, device=device)

    def run(self, max_evals: int = 64, batch: int = 4, resume: bool = False,
            verbose: bool = False, stopping_y=None) -> ResultsLogger:
        import os

        from .checkpoint import load_optimizer

        if resume and os.path.exists(self.ckpt_path):
            load_optimizer(self.optimizer, self.ckpt_path)
            done = getattr(self.optimizer, "num_observed", None)
            if done is None:
                y = getattr(self.optimizer, "y", None)
                done = 0 if y is None else len(y)
            max_evals = max(0, max_evals - int(done))
        return run_experiment(
            self.task, self.optimizer, max_evals=max_evals, batch=batch,
            save_path=self.csv_path, checkpoint_path=self.ckpt_path,
            verbose=verbose, stopping_y=stopping_y,
        )
