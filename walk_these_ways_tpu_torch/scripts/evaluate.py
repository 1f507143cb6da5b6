"""Policy evaluation across domain-randomisation sweeps on one NVIDIA GPU.

Counterpart of the JAX package's scripts/evaluate.py (reference:
go1_gym_learn/eval_metrics/metrics.py METRICS_FNS applied over
domain_randomization.py DR_SETTINGS): loads an exported policy
(`policy_latest.npz`, through scripts/play.load_policy), runs its student
mean under each DR preset on `mob_train_cfg(num_envs)`, and prints tracking
RMSD / power / cost of transport, one row per preset.

Usage: python -m walk_these_ways_tpu_torch.scripts.evaluate
           --policy <policy_latest.npz>
           [--settings rand_regular static_medium] [--steps 250]
           [--num-envs 64] [--seed 0]

`evaluate` runs on a CUDA device; without one it raises unless
`device="cpu"` is asked for.
"""
import argparse
import dataclasses


def evaluate(policy_path: str, settings, steps: int, num_envs: int,
             seed: int, device="cuda"):
    import torch

    from walk_these_ways_tpu_torch.envs.go1_env import (LeggedRobotEnv,
                                                        make_generator)
    from walk_these_ways_tpu_torch.go1_config import mob_train_cfg
    from walk_these_ways_tpu_torch.learn.eval_metrics import (
        DR_SETTINGS, evaluate_policy)
    from walk_these_ways_tpu_torch.scripts.play import load_policy

    unknown = [k for k in settings if k not in DR_SETTINGS]
    if unknown:
        raise ValueError(f"unknown DR settings {unknown}: not in "
                         f"{sorted(DR_SETTINGS)}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the PyTorch port evaluates on a CUDA device: "
                               "torch.cuda.is_available() is False (pass "
                               "device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    policy = load_policy(policy_path, device=dev)
    results = {}
    for name in settings:
        cfg = dataclasses.replace(mob_train_cfg(num_envs=num_envs),
                                  domain_rand=DR_SETTINGS[name])
        env = LeggedRobotEnv(cfg, device=dev)
        out = evaluate_policy(env, policy, make_generator(seed, dev),
                              num_steps=steps)
        results[name] = out
        row = " | ".join(f"{k}={v:.4f}" for k, v in out.items())
        print(f"{name:15s} {row}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy",
                    default="runs/latest/checkpoints/policy_latest.npz")
    ap.add_argument("--settings", nargs="+",
                    default=["rand_regular", "static_medium"])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--num-envs", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    return evaluate(a.policy, a.settings, a.steps, a.num_envs, a.seed)


if __name__ == "__main__":
    main()
