"""Profile a training iteration of the port on one NVIDIA GPU and print its
longest device ops.

Counterpart of the JAX package's scripts/profile_train.py, the profiling
loop the perf work runs on: builds `mob_train_cfg` (or `rough_train_cfg`,
optionally in exact mode), times `--iters` PPO iterations (or, with
`--rollout-only`, 24-step zero-action rollouts) after one warm-up, then
runs one more under `utils/profiling.trace` (torch.profiler: host ops and
the device's kernels) and prints the env-steps/s, the device-busy share of
the traced window and the longest device ops by total device time
(`utils/profiling.device_summary`).  The last line is the same as one JSON
object.

Usage: python -m walk_these_ways_tpu_torch.scripts.profile_train
           [--num-envs 4000] [--iters 10] [--rollout-only]
           [--mode reuse|exact] [--terrain flat|rough] [--out TRACE_DIR]
           [--device cuda]

`--out` also writes the Chrome trace (`TRACE_DIR/trace.json`).  Runs on a
CUDA device; without one it raises unless `--device cpu` is asked for.
"""
import argparse
import dataclasses
import json
import time

STEPS = 24   # control steps of a rollout (one PPO iteration's)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-envs", type=int, default=4000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rollout-only", action="store_true")
    ap.add_argument("--mode", default="reuse", choices=["reuse", "exact"])
    ap.add_argument("--terrain", default="flat", choices=["flat", "rough"])
    ap.add_argument("--out", default=None, metavar="TRACE_DIR")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    import torch

    from walk_these_ways_tpu_torch.envs.go1_env import (LeggedRobotEnv,
                                                        make_generator)
    from walk_these_ways_tpu_torch.go1_config import (mob_train_cfg,
                                                      rough_train_cfg)
    from walk_these_ways_tpu_torch.learn import ppo
    from walk_these_ways_tpu_torch.utils import profiling

    dev = torch.device(a.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the PyTorch port profiles on a CUDA device: "
                               "torch.cuda.is_available() is False (pass "
                               "--device cpu to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    cfg_fn = rough_train_cfg if a.terrain == "rough" else mob_train_cfg
    cfg = cfg_fn(num_envs=a.num_envs)
    if a.mode == "exact":
        cfg = dataclasses.replace(
            cfg, sim=dataclasses.replace(cfg.sim, reuse_matrices=False))
    env = LeggedRobotEnv(cfg, device=dev)
    N = env.num_envs

    if a.rollout_only:
        actions = torch.zeros((N, env.num_actions), device=dev)

        def run(carry):
            state = carry
            for _ in range(STEPS):
                state, _, _, _, _ = env.step(state, actions)
            return state

        carry, _ = env.reset(make_generator(0, dev))
        what = "rollout-only"
    else:
        ts = ppo.init_train_state(make_generator(0, dev), env)
        fn = ppo.make_train_iteration(env, num_steps=STEPS)

        def run(carry):
            es, obs, ts = carry
            es, obs, ts, _ = fn(es, obs, ts)
            return es, obs, ts

        es, obs = env.reset(make_generator(1, dev))
        carry = (es, obs, ts)
        what = "full train iteration"

    carry = run(carry)          # warm-up: the kernels' first launches
    sync()
    t0 = time.time()
    for _ in range(a.iters):
        carry = run(carry)
    sync()
    dt = (time.time() - t0) / max(a.iters, 1)
    rate = STEPS * N / dt
    print(f"{what}: {rate:,.0f} env-steps/s ({dt * 1e3:.1f} ms / "
          f"{STEPS} steps of {N} envs)", flush=True)

    with profiling.trace(a.out) as prof:
        carry = run(carry)
        sync()
    ops, busy, window_ms = profiling.device_summary(prof)
    print(f"traced window {window_ms:.1f} ms, device busy {100 * busy:.1f} %")
    for name, ms, count in ops:
        print(f"  {ms:10.3f} ms  {count:6d} x  {name[:100]}")
    row = dict(what=what, terrain=a.terrain, mode=a.mode, num_envs=N,
               iters=a.iters, seconds_per_iter=dt, env_steps_per_s=rate,
               window_ms=window_ms, device_busy_share=busy,
               top_device_ops=[dict(name=n[:120], ms=ms, count=c)
                               for n, ms, c in ops])
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
