"""Lightweight metrics logger (ml_logger replacement).

Counterpart of the JAX package's utils/metrics_logger.py (reference:
go1_gym_learn/ppo_cse/__init__.py:208-229, scripts/train.py:227-253 chart
spec): append-only JSONL on local disk + a rolling in-memory summary, zero
external services.  Keys follow the reference naming
(``train/episode/rew_<term>/mean``, ``adaptation_loss/mean`` ...) so
downstream chart tooling ports over.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, "metrics.jsonl")
        self._store = defaultdict(list)
        self._t0 = time.time()

    def store(self, **kv):
        for k, v in kv.items():
            self._store[k].append(float(v))

    def summary(self, **extra):
        row = {k: (sum(v) / len(v) if v else 0.0)
               for k, v in self._store.items()}
        row.update({k: float(v) for k, v in extra.items()})
        row["wall_time"] = time.time() - self._t0
        with open(self._path, "a") as f:
            f.write(json.dumps(row) + "\n")
        self._store.clear()
        return row
