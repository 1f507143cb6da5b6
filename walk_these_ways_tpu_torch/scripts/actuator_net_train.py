"""Fit the actuator network from hardware deployment logs, on one NVIDIA GPU.

Counterpart of the JAX package's scripts/actuator_net_train.py (reference:
scripts/actuator_net/utils.py:66-230 `build_mlp` / `train_actuator_network`
+ log preprocessing, and scripts/actuator_net/train.py): reads the pickled
deploy logs (log*.pkl with joint_pos, joint_vel, joint_pos_target,
tau_est / torques, as the deploy logger writes them), builds the
(q_err, q_err-1, q_err-2, qd, qd-1, qd-2) -> tau dataset at one-step
history spacing, and trains the softsign MLP 6->32->32->1 with
`torch.optim.Adam` on the device.  The split and the epochs' permutations
come from numpy's RandomState(seed), as in the JAX package.

Usage: python -m walk_these_ways_tpu_torch.scripts.actuator_net_train
           --log-dir deploy_logs --out resources/actuator_nets/custom.npz
           [--epochs 100]

`train` runs on a CUDA device; without one it raises unless `device="cpu"`
is asked for.
"""
import argparse
import glob
import os
import pickle
import types

import numpy as np

PARAM_NAMES = ("w0", "b0", "w1", "b1", "w2", "b2")


def build_dataset(log_dir: str):
    """(x (T*12, 6), y (T*12, 1)) float32 from every log*.pkl in `log_dir`
    (reference utils.py:148-230: history spacing of 1 step at 50 Hz)."""
    xs, ys = [], []
    for path in sorted(glob.glob(os.path.join(log_dir, "log*.pkl"))):
        with open(path, "rb") as f:
            logs = pickle.load(f)
        for data in logs.values():
            if "joint_pos" not in data or "torques" not in data:
                continue
            q = np.concatenate(data["joint_pos"], axis=0)          # (T, 12)
            qd = np.concatenate(data["joint_vel"], axis=0)
            q_tgt = np.concatenate(data["joint_pos_target"], axis=0)
            tau = np.concatenate(
                data.get("tau_est", data["torques"]), axis=0)
            err = q_tgt - q
            for t in range(2, err.shape[0]):
                xs.append(np.stack([err[t], err[t - 1], err[t - 2],
                                    qd[t], qd[t - 1], qd[t - 2]], axis=-1))
                ys.append(tau[t])                                   # (12,)
    if not xs:
        raise SystemExit(f"no usable logs in {log_dir}")
    x = np.concatenate(xs, axis=0).astype(np.float32)   # (T*12, 6)
    y = np.concatenate(ys, axis=0).astype(np.float32)[:, None]
    return x, y


def _device(device):
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the PyTorch port trains the actuator network on "
                           "a CUDA device: torch.cuda.is_available() is "
                           "False (pass device='cpu' to run on the CPU)")
    return dev


def train(x, y, epochs: int = 100, batch_size: int = 128, lr: float = 8e-4,
          seed: int = 0, device="cuda"):
    """Adam(lr, eps=1e-8) on the MSE of the predicted torque, 4/5 of the
    samples for training and 1/5 held out; returns ActuatorNetParams on
    `device`."""
    import torch

    from walk_these_ways_tpu_torch.models import actuator_net as anet

    dev = _device(device)
    n = x.shape[0]
    n_train = n // 5 * 4
    rng = np.random.RandomState(seed)
    perm = rng.permutation(n)
    xtr = torch.as_tensor(x[perm[:n_train]], device=dev)
    ytr = torch.as_tensor(y[perm[:n_train], 0], device=dev)
    xte = torch.as_tensor(x[perm[n_train:]], device=dev)
    yte = torch.as_tensor(y[perm[n_train:], 0], device=dev)

    init = anet.init_random(seed, device=dev)
    params = types.SimpleNamespace(**{
        k: getattr(init, k).clone().requires_grad_(True)
        for k in PARAM_NAMES})
    opt = torch.optim.Adam(list(vars(params).values()), lr=lr, eps=1e-8)

    steps_per_epoch = max(n_train // batch_size, 1)
    for epoch in range(epochs):
        ep_loss = torch.zeros((), device=dev)
        idx = torch.as_tensor(rng.permutation(n_train), device=dev)
        for i in range(steps_per_epoch):
            b = idx[i * batch_size:(i + 1) * batch_size]
            loss = torch.mean(torch.square(anet.apply(params, xtr[b])
                                           - ytr[b]))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            ep_loss += loss.detach()
        if (epoch + 1) % 10 == 0:
            with torch.no_grad():
                test_loss = float(torch.mean(torch.square(
                    anet.apply(params, xte) - yte)))
            print(f"epoch {epoch+1:3d} | train "
                  f"{float(ep_loss) / steps_per_epoch:.4f} | test "
                  f"{test_loss:.4f}", flush=True)
    return anet.ActuatorNetParams(
        *[getattr(params, k).detach().cpu().numpy() for k in PARAM_NAMES],
        device=dev)


def save(params, out: str):
    """The weights as an .npz with the JAX package's keys."""
    np.savez(out, **{k: getattr(params, k).cpu().numpy()
                     for k in PARAM_NAMES})
    print(f"saved actuator net to {out}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-dir", default="deploy_logs")
    ap.add_argument("--out", default="resources/actuator_nets/custom.npz")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    x, y = build_dataset(a.log_dir)
    print(f"dataset: {x.shape[0]} samples")
    params = train(x, y, epochs=a.epochs, device=a.device)
    save(params, a.out)
    return params


if __name__ == "__main__":
    main()
