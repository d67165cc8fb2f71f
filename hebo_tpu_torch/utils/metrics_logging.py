"""Metrics/observability backends (copy of ``hebo_tpu/utils/metrics_logging.py``).

Parity with the reference's four logging patterns (SURVEY.md §5.5):
  (a) CSV per observation — utils/results_logger.py,
  (b) **mlflow** metrics/params/artifacts (RDUCB mlflow_logging.py) — the
      library is absent in this image, so ``LocalRunTracker`` implements
      the mlflow-API subset (log_param/log_metric/log_artifact, run dirs
      with JSON metric streams) against the local filesystem,
  (c) **tensorboard** (NAP ppo_nap.py:130) — ``TensorboardLogger`` wraps
      torch.utils.tensorboard when available,
  (d) stdout verbose — plain prints.
"""

from __future__ import annotations

import json
import os
import shutil
import time
import uuid
from typing import Any, Dict, Optional

__all__ = ["LocalRunTracker", "TensorboardLogger"]


class LocalRunTracker:
    """mlflow-style run tracking on the local filesystem."""

    def __init__(self, tracking_dir: str = "mlruns", experiment: str = "default"):
        self.root = os.path.join(tracking_dir, experiment)
        self.run_id: Optional[str] = None
        self.run_dir: Optional[str] = None

    def start_run(self, run_name: Optional[str] = None) -> str:
        self.run_id = run_name or uuid.uuid4().hex[:12]
        self.run_dir = os.path.join(self.root, self.run_id)
        os.makedirs(os.path.join(self.run_dir, "artifacts"), exist_ok=True)
        with open(os.path.join(self.run_dir, "meta.json"), "w") as f:
            json.dump({"run_id": self.run_id, "start_time": time.time()}, f)
        return self.run_id

    def log_param(self, key: str, value: Any):
        p = os.path.join(self.run_dir, "params.json")
        d = json.load(open(p)) if os.path.exists(p) else {}
        d[key] = value
        json.dump(d, open(p, "w"))

    def log_params(self, params: Dict[str, Any]):
        for k, v in params.items():
            self.log_param(k, v)

    def log_metric(self, key: str, value: float, step: Optional[int] = None):
        p = os.path.join(self.run_dir, f"metric_{key}.jsonl")
        with open(p, "a") as f:
            f.write(json.dumps({
                "value": float(value), "step": step, "ts": time.time()
            }) + "\n")

    def log_artifact(self, path: str):
        shutil.copy(path, os.path.join(self.run_dir, "artifacts"))

    def get_metric_history(self, key: str):
        p = os.path.join(self.run_dir, f"metric_{key}.jsonl")
        if not os.path.exists(p):
            return []
        return [json.loads(l) for l in open(p)]

    def end_run(self):
        with open(os.path.join(self.run_dir, "meta.json")) as f:
            meta = json.load(f)
        meta["end_time"] = time.time()
        json.dump(meta, open(os.path.join(self.run_dir, "meta.json"), "w"))


class TensorboardLogger:
    """Thin wrapper over torch.utils.tensorboard (present via torch-cpu)."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def log_metric(self, key: str, value: float, step: int = 0):
        self.writer.add_scalar(key, value, step)

    def close(self):
        self.writer.flush()
        self.writer.close()
