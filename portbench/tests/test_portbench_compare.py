"""The comparison that decides `correct`, driven through the rest of a run
(the look for the card skipped) at a small size on the CPU: it passes the
program, and it fails the program with a fault planted under the timed
path, once for each fault a single-rank training cell can have.  On the
card: the control (the reference in the program's place with TF32
products) fails the cell's limits."""
import contextlib
import dataclasses
import time

import pytest
import torch

from portbench import check, control, harness, spec

SEED = 2**31 + 977


def small(name, envs=16, steps=3):
    c = spec.load_cell(name)
    return dataclasses.replace(c, traffic={
        **c.traffic, "num_envs": envs, "num_steps_per_env": steps,
        "log_freq": 2})


def run(cell):
    torch.set_num_threads(1)
    res = harness.run_cell(cell, SEED, 0.1, 0, torch.device("cpu"), {},
                           time.perf_counter(), kind="cpu", limit="n/a")
    assert res is not None
    return res


@contextlib.contextmanager
def patched(obj, attr, make):
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def state_unchanged(orig):
    """The env step returns the physics state it was given."""
    def step(self, state, actions):
        out = orig(self, state, actions)
        return (out[0]._replace(phys=state.phys),) + tuple(out[1:])
    return step


def answer_altered(orig):
    """One env's reward altered where the env step produces it."""
    def step(self, state, actions):
        st, obs, rew, done, info = orig(self, state, actions)
        return st, obs, rew + (torch.arange(rew.shape[0]) == 3) * 0.5, \
            done, info
    return step


def update_unchanged(orig):
    """The update returns the parameters it was given."""
    def update(policy, *a, **kw):
        before = [p.detach().clone() for p in policy.parameters()]
        out = orig(policy, *a, **kw)
        with torch.no_grad():
            for p, b in zip(policy.parameters(), before):
                p.copy_(b)
        return out
    return update


@pytest.mark.parametrize("name", ["cse_flat_4000", "rma_flat_4000"])
def test_sound_run_is_correct(name):
    res = run(small(name))
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(spec.load_cell(name).limits)


@pytest.mark.parametrize("fault", ["state_unchanged", "three_envs_stale",
                                   "answer_altered", "update_unchanged",
                                   "half_batch"])
@pytest.mark.parametrize("name", ["cse_flat_4000", "rma_flat_4000"])
def test_planted_fault_is_not_correct(name, fault):
    from walk_these_ways_tpu_torch.envs import go1_env
    from walk_these_ways_tpu_torch.learn import ppo, ppo_rma
    learner = ppo if spec.load_cell(name).config["algo"] == "cse" \
        else ppo_rma
    plant = {
        "state_unchanged": lambda: patched(go1_env.LeggedRobotEnv, "step",
                                           state_unchanged),
        "three_envs_stale": lambda: control.tail_stale(go1_env, 3),
        "answer_altered": lambda: patched(go1_env.LeggedRobotEnv, "step",
                                          answer_altered),
        "update_unchanged": lambda: patched(learner, "update",
                                            update_unchanged),
        "half_batch": lambda: control.half_batch(ppo),
    }[fault]
    with plant():
        res = run(small(name))
    assert not res["correct"], res["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.load_benchmark()["workloads"]])
def test_control_fails_on_the_card(name, cuda_device):
    """The reference in the program's place with TF32 products fails the
    cell's limits; the program passes them (1024 envs, 3 seeds)."""
    cell = small(name, envs=1024, steps=24)
    for seed in (5, 6, 7):
        prog = control.readings(cell, seed, cuda_device, "program", "none")
        ok, rows = check.verdict(prog["numbers"], cell.limits)
        assert ok, rows
        ctrl = control.readings(cell, seed, cuda_device, "control", "none")
        ok, rows = check.verdict(ctrl["numbers"], cell.limits)
        assert not ok, rows
