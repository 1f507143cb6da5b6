"""The readings that the limits of `limits/<cell>.json` are set from; the
benchmark's own runs do not run this.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
        [--side program|control] [--fault none|half_batch,...]

For each fault and seed, in one process (one a rank): the job is built and
driven through its checked iterations as in a run (no measured window: a
training cell's readings need none), and every compared number is printed
as one JSON line.  A cell over several ranks runs the program on them as a
run does (`ranks.py`), its capture joined on rank 0, which prints.

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
  kernel that leaves a tail block unstepped would; `--fault
  state_unchanged`: every env's; `--fault exchange_left_out`: every sum
  over the ranks left at the rank's own part.  Over several ranks a
  fault is planted on the last rank alone (its envs, its minibatches), so
  that what is read is a fault off rank 0; the exchange on every rank.
- The control over several ranks: the reference runs one rank, so it is
  put in the place of the whole program, on the first card at the cell's
  envs, and computes the batch that the ranks share.
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

from . import harness
from . import ranks as ranks_mod
from . import spec

FAULTS = ("none", "half_batch", "answer_altered", "one_env_stale",
          "three_envs_stale", "state_unchanged", "exchange_left_out")


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
def state_unchanged(go1_env):
    """The physics state returned unchanged by the env step."""
    cls = go1_env.LeggedRobotEnv
    orig = cls.step

    def step(self, state, actions):
        out = orig(self, state, actions)
        return (out[0]._replace(phys=state.phys),) + tuple(out[1:])
    cls.step = step
    try:
        yield
    finally:
        cls.step = orig


@contextlib.contextmanager
def exchange_left_out(mesh_mod):
    """The exchange between the ranks left out: every sum over the ranks
    (`parallel/mesh.all_reduce_sum`, through which the env rows' gathers
    go too) returns this rank's own part."""
    orig = mesh_mod.all_reduce_sum
    mesh_mod.all_reduce_sum = lambda tensors, mesh: list(tensors)
    try:
        yield
    finally:
        mesh_mod.all_reduce_sum = orig


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


def readings(cell, seed: int, device, side: str, fault: str, ranks=None,
             mesh=None) -> dict:
    """The compared numbers of one seed; on a rank of several but 0,
    None."""
    import torch

    from . import check
    from . import job as job_mod
    package = job_mod.PROGRAM if side == "program" \
        else spec.reference(cell.config)
    phases = {}
    t = time.perf_counter()
    sd = job_mod.side(package, cell.config)
    # a fault on the last rank alone, but the exchange, which every rank
    # leaves out (a rank alone would wait for the others)
    here = ranks is None or ranks.rank == ranks.world - 1 \
        or fault == "exchange_left_out"
    ctx = {"half_batch": lambda: half_batch(sd.ppo),
           "answer_altered": lambda: answer_altered(sd.go1_env),
           "one_env_stale": lambda: tail_stale(sd.go1_env, 1),
           "three_envs_stale": lambda: tail_stale(sd.go1_env, 3),
           "state_unchanged": lambda: state_unchanged(sd.go1_env),
           "exchange_left_out": lambda: exchange_left_out(sd.mesh),
           "none": contextlib.nullcontext}[fault if here else "none"]()
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
            job, cap = harness.set_up(cell, seed, device, package, phases,
                                      mesh)
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if ranks is not None:
        cap = harness.join_capture(cap, cell, ranks, device)
        if ranks.rank:
            return None
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
    ap.add_argument("--fault", default="none",
                    help="one of " + ", ".join(FAULTS) + ", or several "
                    "joined by commas")
    # a worker's place, given by rank 0 (ranks.py)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    faults = a.fault.split(",")
    if set(faults) - set(FAULTS):
        ap.error(f"--fault: {sorted(set(faults) - set(FAULTS))} not in "
                 f"{FAULTS}")
    cell = spec.load_cell(a.workload)
    harness.prepare_caches()
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = spec.ranks(cell) if a.side == "program" else 1
    if torch.cuda.device_count() < world:
        harness.log(f"{cell.name} needs {world} cards")
        return 2
    ranks = mesh = None
    device = torch.device("cuda", 0)
    if world > 1:
        if a.rank is None:
            ranks = ranks_mod.start(
                "portbench.control", ["--workload", cell.name, "--seeds",
                                      a.seeds, "--side", a.side, "--fault",
                                      a.fault], world, spec.ROOT)
        else:
            ranks = ranks_mod.attach(a.rank, world)
        ranks.deadline(ranks_mod.JOIN_S, "the ranks' start and join")
        mesh = ranks_mod.join_mesh("cuda")
        device = mesh.device
    for fault in faults:
        for s in a.seeds.split(","):
            if ranks is not None:
                ranks.deadline(ranks_mod.SETUP_S + ranks_mod.CHECK_S,
                               f"seed {s}, fault {fault}")
            row = readings(cell, int(s), device, a.side, fault, ranks, mesh)
            if row is None:
                continue
            row.update(workload=cell.name,
                       card=torch.cuda.get_device_name(0),
                       power_limit=harness.power_limit())
            print(json.dumps(row), flush=True)
    if ranks is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
        if ranks.rank == 0 and not ranks.finish():
            return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
