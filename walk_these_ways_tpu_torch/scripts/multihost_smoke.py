"""Multi-process check of the port's env-axis data parallelism.

Counterpart of the JAX package's scripts/multihost_smoke.py: where that
script joins `jax.distributed` processes, this one starts `--num-processes`
workers of itself as one torch.distributed process group over TCP on
localhost (a free port found by binding port 0; each worker gets the
variables `torchrun` would set and joins through
parallel/mesh.maybe_init_distributed), each holding its rows of the
`--num-envs` envs (parallel/mesh.py) on `--device`: on one card every
worker shares it (gloo; NCCL refuses two ranks on one device), with a card
for each NCCL is chosen.  Each worker trains `--iters` iterations through
learn/runner.Runner and prints a `MULTIHOST` line with the md5 of the raw
bytes of every parameter after the update; the learner state is
replicated, so a gradient sum or a curriculum gather that broke across the
processes would part the checksums.

With `--shared-resume` it also checks the shared-storage checkpoint
(utils/checkpoint.save_shared, every rank writing its rows): cluster A
trains, its Runner commits the full train state to a shared directory at
the end of `learn`, and it runs one more iteration; a FRESH cluster B
resumes from the directory and runs one iteration.  B's checksum must equal
A's continued one, bit for bit.

With `--num-eval-envs E` the env has E eval envs after the train envs
(the rand_large DR preset and a curriculum of their own).  With `--record
DIR` each worker writes what it saw to `DIR/<phase>_rank<r>.pkl` (numpy:
its rows after a reset and after one step of the env, its parameters,
checksums, launch counts and seconds; rank 0 also the gathered env state
after the reset, after the step and after the iterations, and the
Runner's metrics rows), which tests/test_torch_parallel.py and
chip_smoke.py hold against one process; the shared directory is kept as
`DIR/shared_ckpt`.

Usage: python -m walk_these_ways_tpu_torch.scripts.multihost_smoke
           [--num-processes 2] [--iters 2] [--shared-resume]
           [--device cuda|cpu] [--backend gloo|nccl] [--num-envs 4000]
           [--num-eval-envs 0] [--num-steps 24] [--config mob|small]
           [--record DIR]
Prints `multihost_smoke: OK` and exits 0 when every checksum agrees.  With
`--device cuda` (the default) it raises without a CUDA device.
"""
import argparse
import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "walk_these_ways_tpu_torch.scripts.multihost_smoke"
SEED = 0
# seconds a cluster may take
CLUSTER_TIMEOUT_S = 1200.0


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def checksum(arrays) -> str:
    """md5 of the raw bytes of every array, in order."""
    import numpy as np
    d = hashlib.md5()
    for x in arrays:
        d.update(np.ascontiguousarray(np.asarray(x)).tobytes())
    return d.hexdigest()


def params_checksum(ts) -> str:
    return checksum(p.detach().cpu().numpy() for p in ts.policy.parameters())


def params_numpy(ts):
    """The parameters as numpy copies (on the CPU `.numpy()` would share
    their memory)."""
    from walk_these_ways_tpu_torch.utils import convert
    return {k: v.copy() for k, v in
            convert.train_state_to_numpy(ts)["params"].items()}


# every kernel wrapper's launch counter, by module
COUNTERS = (("megastep", ("launches", "p_launches", "normal_launches",
                          "p_normal_launches", "exact_launches",
                          "p_exact_launches")),
            ("contact", ("cache_launches", "substep_launches")),
            ("dynamics", ("launches", "normal_launches")),
            ("entry_cache", ("launches", "normal_launches")))


def launch_counts(reset=False):
    """{"<module>.<counter>": launches} of every kernel wrapper (set to 0
    with `reset`)."""
    import importlib
    out = {}
    for mod_name, names in COUNTERS:
        mod = importlib.import_module("walk_these_ways_tpu_torch.ops."
                                      + mod_name)
        for n in names:
            out[f"{mod_name}.{n}"] = getattr(mod, n)
            if reset:
                setattr(mod, n, 0)
    return out


def configs(a):
    """(train cfg, eval cfg or None) of the run: the eval slice under the
    rand_large DR preset with commands resampled twice as often (a
    curriculum of its own)."""
    from walk_these_ways_tpu_torch.go1_config import (mob_train_cfg,
                                                      small_train_cfg)
    from walk_these_ways_tpu_torch.learn.eval_metrics import DR_SETTINGS
    fn = small_train_cfg if a.config == "small" else mob_train_cfg
    cfg = fn(a.num_envs)
    if not a.num_eval_envs:
        return cfg, None
    ev = fn(a.num_eval_envs)
    return cfg, dataclasses.replace(
        ev, domain_rand=DR_SETTINGS["rand_large"],
        commands=dataclasses.replace(
            ev.commands, resampling_time=ev.commands.resampling_time / 2))


def step_actions(n, dev):
    """The fixed actions of the checked step, for the whole batch."""
    import numpy as np
    import torch
    return torch.tensor(
        0.5 * np.random.RandomState(SEED + 2).uniform(-1, 1, (n, 12)),
        dtype=torch.float32, device=dev)


def env_checks(env, num_steps):
    """A reset and one step of `env`: the gathered states (`reset`,
    `step`) and this rank's own (`local_reset`, `local_step`).  Also:
    sharding the gathered state gives this rank's back, bit for bit; and
    from the stepped state one RMA iteration (learn/ppo_rma.py) of
    `num_steps` steps from seeded weights (`rma`: the parameters before
    and after, their checksum, the logged losses)."""
    from walk_these_ways_tpu_torch.envs.go1_env import make_generator
    from walk_these_ways_tpu_torch.learn import ppo_rma
    from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod

    rows = env.rows
    out = {}
    state, obs = env.reset(make_generator(SEED + 1, env.device))
    g = mesh_mod.gather_env_state((state, obs), rows)
    out["local_reset"] = _state_numpy(state, obs)
    out["roundtrip_bit_exact"] = not differing_leaves(
        _state_numpy(*mesh_mod.shard_env_state(g, rows)),
        out["local_reset"], rows.n)
    out["reset"] = _state_numpy(*g)
    actions = rows.take(step_actions(env.num_envs_global, env.device))
    state, obs, rew, done, info = env.step(state, actions)
    out["local_step"] = _state_numpy(state, obs)
    g_state, g_obs = mesh_mod.gather_env_state((state, obs), rows)
    g_rew, g_done = rows.gather([rew, done])
    out["step"] = dict(_state_numpy(g_state, g_obs), rew=g_rew.cpu().numpy(),
                       done=g_done.cpu().numpy(),
                       ep_count_done=rows.all_reduce_sum(
                           [info.ep_count_done])[0].cpu().numpy())
    ts = ppo_rma.init_train_state(SEED + 3, env)
    before = params_numpy(ts)
    fn = ppo_rma.make_train_iteration(env, num_steps=num_steps)
    _, _, ts, m = fn(state, obs, ts)
    out["rma"] = dict(before=before, params=params_numpy(ts),
                      checksum=params_checksum(ts), metrics={
                          k: float(getattr(m, k)) for k in (
                              "value_loss", "surrogate_loss",
                              "adaptation_loss", "mean_kl", "mean_reward")})
    return out


def differing_leaves(got, want, n, close=(), path=""):
    """[paths of the leaves that differ] between two numpy trees (nested
    dicts) of the state of `n` envs: raw bytes, dtype and shape; the
    env-minor leaves on their envs' lanes (the padded lanes after them
    belong to no env and hold zeros of either sign); the leaves named in
    `close` to 1e-6 (the curriculum's per-bin task sums, which the card's
    `index_add` sums in the order its atomics land, on one rank as on
    two)."""
    import numpy as np
    from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod
    if isinstance(want, dict):
        if set(got) != set(want):
            return [path]
        return [d for k in want for d in differing_leaves(
            got[k], want[k], n, close, f"{path}/{k}")]
    if want is None or got is None:
        return [] if got is None and want is None else [path]
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        return [path]
    name = path.rsplit("/", 1)[-1]
    if mesh_mod.env_axis(name, want, n) == -1:
        if got[..., n:].any() or want[..., n:].any():
            return [path]
        got, want = got[..., :n].copy(), want[..., :n].copy()
    if name in close:
        return [] if np.allclose(got, want, rtol=1e-6, atol=1e-6) else [path]
    return [] if got.tobytes() == want.tobytes() else [path]


def _state_numpy(state, obs):
    from walk_these_ways_tpu_torch.utils import convert
    return dict(env_state=convert.env_state_to_numpy(state),
                obs_dict={k: v.cpu().numpy() for k, v in obs.items()})


def worker(a) -> None:
    import torch

    from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
    from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs
    from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod

    if a.device == "cpu":
        # thousands of tiny ops: one intra-op thread
        torch.set_num_threads(1)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh_mod.maybe_init_distributed(device=a.device, backend=a.backend)
    mesh = mesh_mod.make_mesh(device=a.device, backend=a.backend)
    rank = mesh.rank
    rec = dict(rank=rank, world_size=mesh.world_size, mesh=repr(mesh),
               device=str(mesh.device))
    cfg, eval_cfg = configs(a)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    env = LeggedRobotEnv(cfg, eval_cfg=eval_cfg, mesh=mesh)
    if a.phase != "resume":
        checks = env_checks(env, a.num_steps)
        for k in ("roundtrip_bit_exact", "local_reset", "local_step",
                  "rma"):
            rec[k] = checks.pop(k)
        if rank == 0:
            rec.update(checks)
    big = 10 ** 9
    args = RunnerArgs(num_steps_per_env=a.num_steps, log_freq=1,
                      save_interval=big, curriculum_dump_freq=big,
                      resume=a.phase == "resume",
                      resume_path=a.ckpt_dir if a.phase == "resume" else None,
                      shared_ckpt_dir=a.ckpt_dir if a.phase == "save"
                      else None)
    log_dir = os.path.join(a.log_dir, a.phase)
    runner = Runner(env, log_dir=log_dir, seed=SEED, args=args, mesh=mesh)
    iters = 1 if a.phase == "resume" else a.iters
    launch_counts(reset=True)
    sync()
    t0 = time.time()
    # the first iteration alone first (a one-iteration comparison; with a
    # shared directory also its overwrite at the end of the next `learn`)
    runner.learn(1)
    rec["params_first"] = params_numpy(runner.train_state)
    if iters > 1:
        runner.learn(iters - 1)
    sync()
    rec["learn_seconds"] = time.time() - t0
    rec["launches"] = launch_counts()
    rec["iterations"] = runner.train_state.iteration
    ts = runner.train_state
    rec["params"] = params_numpy(ts)
    rec["checksum"] = params_checksum(ts)
    rec["generator_checksums"] = dict(
        learner=checksum([ts.rng.get_state().numpy()]),
        env=checksum([runner.env_state.rng.get_state().numpy()]))
    if rank == 0:
        rec["metrics"] = [json.loads(ln) for ln in open(
            os.path.join(log_dir, "metrics.jsonl"))]
    line_sum = rec["checksum"]
    if a.phase == "save":
        # the whole batch after the iterations, as the shared directory
        # holds it
        saved = _state_numpy(*mesh_mod.gather_env_state(
            (runner.env_state, runner.obs_dict), env.rows))
        if rank == 0:
            rec["saved"] = saved
        # the shared directory holds the state after `iters`; one more
        # iteration, which the resumed cluster must reproduce
        runner.args = dataclasses.replace(args, shared_ckpt_dir=None)
        runner.learn(1)
        rec["continued_checksum"] = line_sum = params_checksum(
            runner.train_state)
    if a.record:
        with open(os.path.join(a.record, f"{a.phase}_rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(rec, f)
    mesh.barrier()
    per_iter = ("" if rank else " s_per_iter=" + ",".join(
        f"{r['time_iter']:.3f}" for r in rec["metrics"]))
    print(f"MULTIHOST rank={rank}/{mesh.world_size} phase={a.phase} "
          f"device={mesh.device} backend={mesh.backend} "
          f"envs={env.num_envs}/{env.num_envs_global} "
          f"launches={rec['launches']['megastep.launches']} "
          f"seconds={rec['learn_seconds']:.3f}{per_iter} "
          f"checksum={line_sum}", flush=True)


def _run_cluster(a, phase, ckpt_dir):
    """Start one process group of `--num-processes` workers; their
    MULTIHOST checksums if every worker printed one and they agree, else
    None."""
    port = free_port()
    procs = []
    for i in range(a.num_processes):
        env = dict(os.environ, RANK=str(i), LOCAL_RANK=str(i),
                   WORLD_SIZE=str(a.num_processes),
                   LOCAL_WORLD_SIZE=str(a.num_processes),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        cmd = [sys.executable, "-m", MODULE, "--worker", "--phase", phase,
               "--iters", str(a.iters), "--device", a.device,
               "--num-envs", str(a.num_envs),
               "--num-eval-envs", str(a.num_eval_envs),
               "--num-steps", str(a.num_steps), "--config", a.config,
               "--log-dir", a.log_dir]
        for flag, v in (("--backend", a.backend), ("--ckpt-dir", ckpt_dir),
                        ("--record", a.record)):
            if v:
                cmd += [flag, v]
        procs.append(subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=ROOT))
    try:
        outs = [p.communicate(timeout=CLUSTER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    checksums = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        line = next((ln for ln in out.splitlines()
                     if ln.startswith("MULTIHOST")), "")
        print(line or f"rank {i}: NO MULTIHOST LINE (rc={p.returncode})",
              flush=True)
        if p.returncode != 0 or not line:
            # a worker without its line fails the run: empty "checksums"
            # would compare equal and fake a pass
            print(f"--- rank {i} failed (rc={p.returncode}); tail ---")
            print("\n".join(out.splitlines()[-25:]), flush=True)
            return None
        checksums.append(line.rsplit("checksum=", 1)[-1])
    if len(set(checksums)) != 1:
        print(f"FAIL: the ranks' checksums differ: {checksums}")
        return None
    return checksums


def build_kernels(a):
    """Build the kernels the workers launch once, here, before they
    start (each would otherwise compile its own copy)."""
    from walk_these_ways_tpu_torch.models.robot import go1
    from walk_these_ways_tpu_torch.ops import _build, megastep
    _build.build_libraries([megastep.library_spec(go1(), 32, 6)])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--shared-resume", action="store_true",
                   help="check a shared-storage checkpoint across two "
                        "clusters started one after the other")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--backend", choices=["gloo", "nccl"], default=None,
                   help="default: NCCL with a card for every rank, else gloo")
    p.add_argument("--num-envs", type=int, default=4000,
                   help="train envs of the whole batch")
    p.add_argument("--num-eval-envs", type=int, default=0,
                   help="eval envs after the train envs (the rand_large "
                        "DR preset, a curriculum of their own)")
    p.add_argument("--num-steps", type=int, default=24,
                   help="control steps per iteration")
    p.add_argument("--config", choices=["mob", "small"], default="mob")
    p.add_argument("--record", type=str, default=None, metavar="DIR")
    # a worker's own flags (--log-dir: where its Runner writes)
    p.add_argument("--log-dir", type=str, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--phase", choices=["train", "save", "resume"],
                   default="train", help=argparse.SUPPRESS)
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)

    if a.worker:
        worker(a)
        return 0
    if a.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("multihost_smoke --device cuda needs a CUDA "
                               "device: torch.cuda.is_available() is False "
                               "(pass --device cpu to run on the CPU)")
        build_kernels(a)
    tmp = tempfile.mkdtemp(prefix="wtw_multihost_")
    try:
        a.log_dir = os.path.join(tmp, "runs")
        if a.record:
            os.makedirs(a.record, exist_ok=True)
        if not a.shared_resume:
            cs = _run_cluster(a, "train", None)
            if cs is None:
                return 1
            print(f"multihost_smoke: OK — {a.num_processes} processes agree "
                  f"(checksum {cs[0]})", flush=True)
            return 0
        # kept beside the records, so a test can resume from it elsewhere
        ckpt_dir = os.path.join(a.record or tmp, "shared_ckpt")
        print(f"shared checkpoint dir: {ckpt_dir}", flush=True)
        cs_a = _run_cluster(a, "save", ckpt_dir)
        if cs_a is None:
            return 1
        cs_b = _run_cluster(a, "resume", ckpt_dir)
        if cs_b is None:
            return 1
        if cs_a[0] != cs_b[0]:
            print(f"FAIL: the resumed cluster parted from the continued run: "
                  f"{cs_a[0]} vs {cs_b[0]}")
            return 1
        print(f"multihost_smoke: OK — a fresh {a.num_processes}-process "
              f"cluster resumed from shared storage bit-exactly (checksum "
              f"{cs_b[0]})", flush=True)
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
