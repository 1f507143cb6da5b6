"""BENCHMARK.json against the contract's character rules, and every cell and
metric resolved by name to its files."""
import json
import os
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")


def bench():
    return spec.load_benchmark()


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["portbench"]
    assert len(json.dumps(b)) < 64 * 1024


def test_names_and_units():
    b = bench()
    names = []
    for c in b["configs"]:
        names.append(c["name"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        names.append(w["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert set(m.get("workloads", cells)) <= cells
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for n in names:
        assert NAME.match(n), n
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    assert c.config["algo"] in ("cse", "rma")
    assert int(c.traffic["num_envs"]) > 0
    assert c.limits and all(v >= 0 for v in c.limits.values())
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    spec.load_benchmark()["per_layer"]])
def test_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_new_cell_is_picked_up_from_its_files(tmp_path):
    """A cell that a later change adds is new files and a new entry: the
    harness finds it without an edit to any file that is there."""
    root = tmp_path
    shutil.copytree(os.path.join(spec.ROOT, "portbench"),
                    root / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    b = bench()
    b["workloads"].append({"name": "cse_flat_2048", "config": "go1_mob_cse",
                           "traffic": "flat_2048", "chips": 1,
                           "why": "a later cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    traffic = json.loads((root / "portbench/workloads/flat_4000.json")
                         .read_text())
    traffic["num_envs"] = 2048
    (root / "portbench/workloads/flat_2048.json").write_text(
        json.dumps(traffic))
    shutil.copy(root / "portbench/limits/cse_flat_4000.json",
                root / "portbench/limits/cse_flat_2048.json")
    c = spec.load_cell("cse_flat_2048", root=str(root))
    assert c.traffic["num_envs"] == 2048
    assert c.config_name == "go1_mob_cse"
    with pytest.raises(KeyError):
        spec.load_cell("no_such_cell", root=str(root))
