"""A configuration names its own plain reference (`"reference"`, a package)
and learner (`"learner"`, a module path under it and the program): the
harness builds the reference side from them, a package that does not import
fails with its name, and the committed configurations, which name neither,
resolve to portbench.reference.wtw and their algo's learner."""
import dataclasses
import sys
import time

import pytest
import torch

from portbench import harness, job, spec

STANDIN = "portbench.tests.standin_ref"


@pytest.mark.parametrize("config, learner", [("go1_mob_cse", "learn.ppo"),
                                             ("go1_mob_rma", "learn.ppo_rma")])
def test_committed_configurations_resolve_as_before(config, learner):
    cfg = next(spec.load_cell(w["name"]).config
               for w in spec.load_benchmark()["workloads"]
               if w["config"] == config)
    assert "reference" not in cfg and "learner" not in cfg
    assert spec.reference(cfg) == "portbench.reference.wtw"
    ref = job.reference_side(cfg)
    assert ref.name == "portbench.reference.wtw"
    assert ref.learner.__name__ == "portbench.reference.wtw." + learner
    assert ref.ppo.__name__ == "portbench.reference.wtw.learn.ppo"
    prog = job.side(job.PROGRAM, cfg)
    assert prog.learner.__name__ == "walk_these_ways_tpu_torch." + learner
    assert prog.go1_env.__name__ == "walk_these_ways_tpu_torch.envs.go1_env"


def test_learner_named_by_the_configuration():
    cfg = dict(spec.load_cell("cse_flat_4000").config,
               learner="learn.ppo_rma")
    assert job.reference_side(cfg).learner.__name__.endswith(
        "wtw.learn.ppo_rma")
    with pytest.raises(ValueError, match="algo"):
        spec.learner({"algo": "sac"})


def test_missing_reference_fails_with_its_name():
    cfg = dict(spec.load_cell("cse_flat_4000").config,
               reference="portbench.reference.no_such_reference")
    with pytest.raises(ImportError,
                       match="portbench.reference.no_such_reference"):
        job.reference_side(cfg)


def test_run_builds_its_reference_from_the_named_package():
    """A run of a cell whose configuration names the stand-in package:
    the check's reference env and learner are the stand-in's modules, and
    the run is correct."""
    c = spec.load_cell("cse_flat_4000")
    c = dataclasses.replace(
        c, config=dict(c.config, reference=STANDIN),
        traffic={**c.traffic, "num_envs": 16, "num_steps_per_env": 3,
                 "log_freq": 2})
    ref = job.reference_side(c.config)
    built = []
    orig = ref.go1_env.LeggedRobotEnv.__init__

    def init(self, *a, **kw):
        built.append(type(self).__module__)
        orig(self, *a, **kw)
    ref.go1_env.LeggedRobotEnv.__init__ = init
    torch.set_num_threads(1)
    try:
        res = harness.run_cell(c, 2**31 + 31, 0.1, 0, torch.device("cpu"),
                               {}, time.perf_counter(), kind="cpu",
                               limit="n/a")
    finally:
        ref.go1_env.LeggedRobotEnv.__init__ = orig
    assert built == [STANDIN + ".envs.go1_env"]
    assert STANDIN + ".learn.ppo" in sys.modules
    assert res["correct"], res["checks"]
