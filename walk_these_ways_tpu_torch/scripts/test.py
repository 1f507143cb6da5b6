"""Env smoke test on one NVIDIA GPU: small world, zero actions, 1000 steps.

Counterpart of the JAX package's scripts/test.py (reference
scripts/test.py:14-206, the install-verification and step-parity reference
config): a handful of envs with the full feature set (actuator net, lag
buffer, 15-dim gait commands, flat tiles), stepped with zero actions while
printing basic invariants.

Usage: python -m walk_these_ways_tpu_torch.scripts.test
           [--num-envs 3] [--steps 1000]

`run_env` runs on a CUDA device; without one it raises unless
`device="cpu"` is asked for.
"""
import argparse
import time


def run_env(num_envs: int = 3, steps: int = 1000, seed: int = 0,
            device="cuda"):
    import numpy as np
    import torch

    from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
    from walk_these_ways_tpu_torch.envs.wrappers import VecEnvAdapter
    from walk_these_ways_tpu_torch.go1_config import mob_train_cfg

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the PyTorch port steps its envs on a CUDA "
                               "device: torch.cuda.is_available() is False "
                               "(pass device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = mob_train_cfg(num_envs=num_envs)
    env = VecEnvAdapter(LeggedRobotEnv(cfg, device=dev), seed=seed)
    obs = env.reset()
    zero = torch.zeros((num_envs, 12), device=dev)
    t0 = time.time()
    for i in range(steps):
        obs, rew, done, info = env.step(zero)
        if (i + 1) % 200 == 0:
            z = env.state.phys.base_pos[:, 2].cpu().numpy()
            print(f"step {i + 1:5d} | base z {z.mean():.3f} | "
                  f"rew {float(rew.mean()):.4f} | done {int(done.sum())}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{steps} steps x {num_envs} envs in {dt:.1f}s "
          f"({steps * num_envs / dt:,.0f} env-steps/s)")
    assert np.isfinite(obs["obs"].cpu().numpy()).all(), "non-finite obs"
    print("OK")
    return obs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=3)
    p.add_argument("--steps", type=int, default=1000)
    a = p.parse_args(argv)
    run_env(a.num_envs, a.steps)


if __name__ == "__main__":
    main()
