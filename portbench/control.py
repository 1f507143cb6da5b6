"""The readings that the limits of `limits/<cell>.json` are set from; the
benchmark's own runs do not run this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
        [--side program|control] [--fault none|half_batch]

For each seed, one process: the job is built and driven through its
checked iterations as in a run (no measured window: a training cell's
readings need none), and every compared number is printed as one JSON line.

- `--side program`: the program, as the benchmark runs it (the sound
  readings, the lower end of each limit).
- `--side control`: the reference put in the program's place and computed
  with TF32 products, the nearest precision below the configuration's
  float32 (the upper end, where it reads three times the lower or more).
- `--fault half_batch`, on either side: every minibatch's second half left
  out and the losses' means taken over the rest; `--fault answer_altered`:
  one env's reward and done altered where the env step produces them;
  `--fault one_env_stale` (`three_envs_stale`): the last env's (the last
  three envs') physics state returned unchanged by every env step, as a
  kernel that leaves a tail block unstepped would.
A step that returns its state unchanged needs no run: every line carries
what the physics and the observations would read then (`stale`), and the
parameters' change reads 1."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

from . import harness, spec


ALTERED_ENV = 3      # the env whose step outputs `answer_altered` alters


@contextlib.contextmanager
def answer_altered(go1_env):
    """One env's reward (+1) and done (flipped) altered where the env step
    produces them."""
    cls = go1_env.LeggedRobotEnv
    orig = cls.step

    def step(self, state, actions):
        st, obs, rew, done, info = orig(self, state, actions)
        rew, done = rew.clone(), done.clone()
        rew[ALTERED_ENV] += 1.0
        done[ALTERED_ENV] = ~done[ALTERED_ENV]
        return st, obs, rew, done, info
    cls.step = step
    try:
        yield
    finally:
        cls.step = orig


@contextlib.contextmanager
def tail_stale(go1_env, envs: int):
    """The last `envs` envs' physics state returned unchanged by the env
    step."""
    import torch
    cls = go1_env.LeggedRobotEnv
    orig = cls.step

    def step(self, state, actions):
        out = orig(self, state, actions)
        phys = type(state.phys)(*(
            torch.cat([new[:-envs], old[-envs:]]) for new, old in
            zip(out[0].phys, state.phys)))
        return (out[0]._replace(phys=phys),) + tuple(out[1:])
    cls.step = step
    try:
        yield
    finally:
        cls.step = orig


@contextlib.contextmanager
def half_batch(ppo):
    orig = ppo.minibatches

    def minibatches(data, perm, num_mini_batches, rows):
        out, mb = orig(data, perm, num_mini_batches, rows)
        half = mb // 2
        return [(tuple(x[:half] for x in cols), pos[:half])
                for cols, pos in out], half
    ppo.minibatches = minibatches
    try:
        yield
    finally:
        ppo.minibatches = orig


def readings(cell, seed: int, device, side: str, fault: str) -> dict:
    import torch

    from . import check
    from . import job as job_mod
    package = job_mod.PROGRAM if side == "program" else job_mod.REFERENCE
    phases = {}
    t = time.perf_counter()
    sd = job_mod.side(package, cell.config["algo"])
    ctx = {"half_batch": lambda: half_batch(sd.ppo),
           "answer_altered": lambda: answer_altered(sd.go1_env),
           "one_env_stale": lambda: tail_stale(sd.go1_env, 1),
           "three_envs_stale": lambda: tail_stale(sd.go1_env, 3),
           "none": contextlib.nullcontext}[fault]()
    with ctx:
        if side == "control":
            # the env is built in float32 (it refuses TF32), then the
            # iterations run with TF32 products
            orig_build = job_mod.build

            def build(*a, **kw):
                j = orig_build(*a, **kw)
                torch.backends.cuda.matmul.allow_tf32 = True
                return j
            job_mod.build = build
            try:
                job, cap = harness.set_up(cell, seed, device, package, phases)
            finally:
                job_mod.build = orig_build
                torch.backends.cuda.matmul.allow_tf32 = False
        else:
            job, cap = harness.set_up(cell, seed, device, package, phases)
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    nums, extras = check.numbers(cap, cell, device)
    return dict(seed=seed, side=side, fault=fault, numbers=nums,
                stale=extras["stale"],
                change_left_out=extras["change_left_out"],
                worst=extras["worst"],
                seconds=time.perf_counter() - t)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--side", choices=("program", "control"),
                    default="program")
    ap.add_argument("--fault", choices=("none", "half_batch",
                                        "answer_altered", "one_env_stale",
                                        "three_envs_stale"),
                    default="none")
    a = ap.parse_args(argv)
    cell = spec.load_cell(a.workload)
    harness.prepare_caches()
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    for s in a.seeds.split(","):
        row = readings(cell, int(s), device, a.side, a.fault)
        row.update(workload=cell.name, card=torch.cuda.get_device_name(0),
                   power_limit=harness.power_limit())
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
