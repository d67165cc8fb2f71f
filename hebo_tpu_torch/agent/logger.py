"""Episode logger for agent runs (JSONL)."""

from __future__ import annotations

import json
import os
import time
from typing import Optional

__all__ = ["EpisodeLogger"]


class EpisodeLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.episodes = []

    def log_episode(self, memory, reward: float):
        rec = {
            "task": memory.task_description,
            "steps": memory.steps,
            "reward": reward,
            "ts": time.time(),
        }
        self.episodes.append(rec)
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
