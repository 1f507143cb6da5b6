"""Deployment episode logger.

Rebuild of the reference MultiLogger/EpisodeLogger (reference:
go1_gym_deploy/utils/logger.py:27-79): accumulates per-step info dicts and
pickles them as log.pkl — the input format for actuator-network refitting
(scripts/actuator_net_train.py).
"""
from __future__ import annotations

import os
import pickle
import time
from collections import defaultdict


class EpisodeLogger:
    def __init__(self):
        self.infos = defaultdict(list)

    def log(self, info: dict):
        for k, v in info.items():
            self.infos[k].append(v)

    def to_dict(self):
        return {k: v for k, v in self.infos.items()}


class MultiLogger:
    def __init__(self, root: str):
        self.root = root
        self.loggers = defaultdict(EpisodeLogger)

    def log(self, name: str, info: dict):
        self.loggers[name].log(info)

    def save(self):
        os.makedirs(self.root, exist_ok=True)
        path = os.path.join(self.root, f"log_{int(time.time())}.pkl")
        with open(path, "wb") as f:
            pickle.dump({k: l.to_dict() for k, l in self.loggers.items()}, f)
        print(f"saved deploy log to {path}")
        return path
