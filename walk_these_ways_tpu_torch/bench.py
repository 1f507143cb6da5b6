"""Training throughput of the PyTorch port at 4000 envs on one NVIDIA GPU.

Counterpart of the JAX package's bench.py: end-to-end env-steps/s of the
complete training iteration (physics x4 decimation + actuator net + MoB
rewards + DR + curriculum + PPO/adaptation update — `mob_train_cfg`, the
`scripts/train.py` configuration of the reference, or with `terrain="rough"`
`rough_train_cfg`, the same on a rough heightfield), host clock around
`iters` iterations that end in a synchronise, after `warmup` iterations.

Prints ONE JSON line: {"metric", "value", "unit", "gpu", "power_limit",
"num_envs", "iterations", "seconds"}.  There is no baseline ratio: the
reference publishes no throughput, and the JAX package's 60,000 env-steps/s
is an assumption, not a measurement.  One attempt, no retry: a failure
raises.  Without a CUDA device it raises.

Usage: python -m walk_these_ways_tpu_torch.bench [num_envs]
           [--terrain rough]
"""
import json
import subprocess
import time


def _smi(field: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]


def main(num_envs: int = 4000, warmup: int = 3, iters: int = 20,
         terrain: str = "flat"):
    import torch

    from walk_these_ways_tpu_torch.envs.go1_env import (LeggedRobotEnv,
                                                        make_generator)
    from walk_these_ways_tpu_torch.go1_config import (mob_train_cfg,
                                                      rough_train_cfg)
    from walk_these_ways_tpu_torch.learn import ppo as ppo_mod

    if terrain not in ("flat", "rough"):
        raise ValueError(f"terrain {terrain!r}: flat or rough")
    if not torch.cuda.is_available():
        raise RuntimeError("the bench measures a CUDA device: "
                           "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg_fn = rough_train_cfg if terrain == "rough" else mob_train_cfg
    env = LeggedRobotEnv(cfg_fn(num_envs=num_envs))
    ts = ppo_mod.init_train_state(0, env)
    env_state, obs_dict = env.reset(make_generator(1, env.device),
                                    random_episode_lengths=True)
    num_steps = 24
    train_iter = ppo_mod.make_train_iteration(env, num_steps=num_steps)

    for _ in range(warmup):
        env_state, obs_dict, ts, metrics = train_iter(env_state, obs_dict, ts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        env_state, obs_dict, ts, metrics = train_iter(env_state, obs_dict, ts)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    row = {
        "metric": f"train_env_steps_per_s_{num_envs}env"
                  + ("" if terrain == "flat" else f"_{terrain}"),
        "value": iters * num_steps * num_envs / dt,
        "unit": "env-steps/s",
        "gpu": torch.cuda.get_device_name(0),
        "power_limit": _smi("power.limit"),
        "num_envs": num_envs, "iterations": iters, "seconds": dt,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("num_envs", type=int, nargs="?", default=4000)
    ap.add_argument("--terrain", choices=["flat", "rough"], default="flat")
    a = ap.parse_args()
    main(num_envs=a.num_envs, terrain=a.terrain)
