"""Evaluate an actuator network against hardware deployment logs, on one
NVIDIA GPU.

Counterpart of the JAX package's scripts/actuator_net_eval.py (reference:
scripts/actuator_net/eval.py, which calls
train_actuator_network_and_plot_predictions with load_pretrained_model=True,
scripts/actuator_net/utils.py:66-145): loads the softsign MLP (.npz, by
default the committed reference net), rebuilds the (q_err x3, qd x3) -> tau
dataset from the deploy logs with this package's `build_dataset`, and
reports the prediction error, overall and per joint, beside the PD-torque
baseline that the actuator net must beat to be worth deploying.

Usage: python -m walk_these_ways_tpu_torch.scripts.actuator_net_eval
           --log-dir deploy_logs
           [--net resources/actuator_nets/unitree_go1.npz] [--out eval.json]

Runs on a CUDA device; without one it raises unless `--device cpu` is
asked for.
"""
import argparse
import json

import numpy as np

from walk_these_ways_tpu_torch.scripts.actuator_net_train import (
    _device, build_dataset)


def load_net(path: str, device="cuda"):
    """x (n, 6) numpy -> predicted torque (n,) numpy."""
    import torch

    from walk_these_ways_tpu_torch.models import actuator_net as anet

    dev = _device(device)
    params = anet.load(path, device=dev)

    def predict(x):
        with torch.no_grad():
            return anet.apply(params, torch.as_tensor(x, device=dev)).cpu() \
                .numpy()

    return predict


def pd_baseline(log_dir: str, kp: float = 20.0, kd: float = 0.5):
    """tau = kp*err - kd*qd on the same samples (the model the actuator net
    replaces; reference legged_robot_config.py control gains)."""
    x, y = build_dataset(log_dir)
    tau_pd = kp * x[:, 0] - kd * x[:, 3]
    return float(np.mean((tau_pd - y[:, 0]) ** 2))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default="deploy_logs")
    ap.add_argument("--net", default="resources/actuator_nets/unitree_go1.npz")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)

    x, y = build_dataset(a.log_dir)
    pred = load_net(a.net, a.device)(x)
    err = pred.reshape(-1) - y.reshape(-1)
    mse = float(np.mean(err ** 2))
    var = float(np.var(y))
    r2 = 1.0 - mse / max(var, 1e-9)

    # per-joint breakdown: dataset rows come 12 joints at a time
    per_joint = {}
    nj = 12
    if x.shape[0] % nj == 0:
        e = err.reshape(-1, nj)
        yv = y.reshape(-1, nj)
        for j in range(nj):
            per_joint[f"joint_{j}"] = {
                "mse": float(np.mean(e[:, j] ** 2)),
                "r2": float(1.0 - np.mean(e[:, j] ** 2)
                            / max(np.var(yv[:, j]), 1e-9)),
            }

    result = {
        "net": a.net,
        "log_dir": a.log_dir,
        "samples": int(x.shape[0]),
        "mse": mse,
        "r2": r2,
        "mse_pd_baseline": pd_baseline(a.log_dir),
        "per_joint": per_joint,
    }
    print(json.dumps({k: v for k, v in result.items() if k != "per_joint"}))
    for j, stats in per_joint.items():
        print(f"  {j}: mse={stats['mse']:.4f} r2={stats['r2']:.3f}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {a.out}")
    return result


if __name__ == "__main__":
    main()
