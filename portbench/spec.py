"""The cell a run measures, read from BENCHMARK.json and the data files it
names: the configuration (`configs/<config>.json`), the traffic
(`workloads/<traffic>.json`), the limits of the comparison
(`limits/<cell>.json`) and one reader per per-layer metric
(`metrics/<metric>.py`).  Nothing here names a cell: a new cell is new
files and a new entry of BENCHMARK.json."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # configs/<config>.json
    traffic_name: str
    traffic: dict         # workloads/<traffic>.json
    limits: dict          # limits/<cell>.json: number name -> limit
    end_to_end: tuple     # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of BENCHMARK.json with its data files; raises
    KeyError for a cell that is not there and FileNotFoundError for a file
    that is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = os.path.join(root, "portbench")
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"],
        config=_read_json(os.path.join(root, configs[w["config"]]["file"])),
        traffic_name=w["traffic"],
        traffic=_read_json(os.path.join(here, "workloads",
                                        w["traffic"] + ".json")),
        limits=_read_json(os.path.join(here, "limits", name + ".json")),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)))


def reader(metric: str, root: str = ROOT):
    """The `read(ctx)` function of `metrics/<metric>.py`."""
    path = os.path.join(root, "portbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
