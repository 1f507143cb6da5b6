"""A cell over several ranks on the CPU, for the tests:

    python -m portbench.tests.ranks_probe --ranks 2 --envs 32 --seed S
        [--seconds 0.2] [--trace 0|1] [--dump DIR] [--faults a,b,...]

The cell `cse_flat_16384_dp4` cut to `--envs` envs, 3 control steps an
iteration and `--ranks` ranks on gloo; its ranks are started and joined as a
run starts them (portbench/ranks.py), then

- without `--faults`: the rest of a run (`harness.run_cell`: set-up, a
  window of `--seconds`, the capture joined, the check); rank 0 prints the
  result's line.  With `--dump DIR` every rank saves its own capture there
  (`local<rank>.pt`) and rank 0 the joined one (`joined.pt`);
- with `--faults`: `control.readings` of each fault in turn in the same
  group (planted as on the card: on the last rank, the exchange on every
  rank); rank 0 prints one line of numbers and verdict each.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

CELL = "cse_flat_16384_dp4"
CAPTURED = ("raw", "traj", "last_obs", "gae", "env_checks", "losses",
            "first_grad", "params_after", "replicas")


def small_cell(envs: int, ranks: int):
    from portbench import spec
    c = spec.load_cell(CELL)
    return dataclasses.replace(c, chips=ranks, traffic={
        **c.traffic, "num_envs": envs, "num_steps_per_env": 3,
        "log_freq": 2, "ranks": ranks})


def dumping(harness, out_dir: str):
    """harness.join_capture, saving each rank's capture and the joined
    one under `out_dir`."""
    import torch
    orig = harness.join_capture

    def join_capture(cap, cell, ranks, device):
        torch.save({k: getattr(cap, k) for k in CAPTURED if k != "replicas"},
                   os.path.join(out_dir, f"local{ranks.rank}.pt"))
        out = orig(cap, cell, ranks, device)
        if out is not None:
            torch.save({k: getattr(out, k) for k in CAPTURED},
                       os.path.join(out_dir, "joined.pt"))
        return out
    harness.join_capture = join_capture


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m portbench.tests.ranks_probe")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=0.2)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--dump", default=None)
    ap.add_argument("--faults", default=None)
    ap.add_argument("--rank", type=int, default=None)
    a = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    from portbench import check, control, harness, spec
    from portbench import ranks as ranks_mod
    torch.set_num_threads(1)
    cell = small_cell(a.envs, a.ranks)
    if a.rank is None:
        own = [x for x in (argv if argv is not None else sys.argv[1:])]
        ranks = ranks_mod.start("portbench.tests.ranks_probe", own, a.ranks,
                                spec.ROOT)
    else:
        ranks = ranks_mod.attach(a.rank, a.ranks)
    if a.dump:
        dumping(harness, a.dump)
    if a.faults is None:
        res = harness.run_cell(cell, a.seed, a.seconds, a.trace, "cpu", {},
                               t_start, kind="cpu", limit="n/a",
                               ranks=ranks)
        if res is None:
            return 3
        if ranks.rank == 0:
            print(json.dumps(res), flush=True)
        return 0
    mesh = ranks_mod.join_mesh("cpu")
    for fault in a.faults.split(","):
        row = control.readings(cell, a.seed, mesh.device, "program", fault,
                               ranks, mesh)
        if row is not None:
            ok, rows = check.verdict(row["numbers"], cell.limits)
            print(json.dumps(dict(fault=fault, correct=ok,
                                  numbers=row["numbers"])), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()
    if ranks.rank == 0 and not ranks.finish():
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
