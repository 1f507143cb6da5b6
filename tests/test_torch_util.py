"""Shared helpers for the PyTorch port's parity tests, and the import scan.

The helpers make inputs from numpy seeds and hand the same arrays to the JAX
function and to its counterpart in the port.  JAX stays on the CPU
(tests/conftest.py); the port is called with device="cpu", where every
kernel wrapper takes its plain PyTorch version.
"""
import ast
import os

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "walk_these_ways_tpu_torch")


def t(x):
    """numpy / jax array -> float32 (or int / bool) CPU tensor, copied."""
    a = np.array(x)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def assert_close(torch_val, jax_val, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(
        torch_val.detach().cpu().numpy() if isinstance(torch_val, torch.Tensor)
        else np.asarray(torch_val),
        np.asarray(jax_val), rtol=rtol, atol=atol, err_msg=err_msg)


def random_phys_np(n, seed, height=0.34):
    """A batch of plausible Go1 states (numpy): default pose scaled by
    U(0.5, 1.5), random yaw, small base velocities."""
    rs = np.random.RandomState(seed)
    default = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                        0.1, 1.0, -1.5, -0.1, 1.0, -1.5], np.float32)
    yaw = rs.uniform(-3.14, 3.14, n)
    quat = np.stack([np.zeros(n), np.zeros(n), np.sin(yaw / 2),
                     np.cos(yaw / 2)], axis=-1)
    return dict(
        base_pos=np.concatenate([rs.uniform(-1, 1, (n, 2)),
                                 np.full((n, 1), height)],
                                axis=-1).astype(np.float32),
        base_quat=quat.astype(np.float32),
        base_lin_vel=rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        base_ang_vel=rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        q=(default[None] * rs.uniform(0.5, 1.5, (n, 12))).astype(np.float32),
        qd=rs.uniform(-1.0, 1.0, (n, 12)).astype(np.float32),
    )


def random_dyn_np(n, seed):
    rs = np.random.RandomState(seed + 1000)
    return dict(
        payload=rs.uniform(-1.0, 3.0, n).astype(np.float32),
        com_displacement=rs.uniform(-0.1, 0.1, (n, 3)).astype(np.float32),
        friction=rs.uniform(0.1, 3.0, n).astype(np.float32),
        restitution=rs.uniform(0.0, 0.4, n).astype(np.float32),
        gravity=(np.array([0.0, 0.0, -9.8], np.float32)[None]
                 + rs.uniform(-1, 1, (n, 3))).astype(np.float32),
    )


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of the port (its scripts and bench included), nor
    chip_smoke.py or chip_mutants.py, imports jax or walk_these_ways_tpu
    (AST scan; nothing is launched)."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "chip_mutants.py")]
    for root, _, fs in os.walk(PORT):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    assert len(files) > 10
    for entry in ("scripts/train.py", "bench.py", "learn/runner.py",
                  "utils/checkpoint.py", "utils/profiling.py"):
        assert os.path.join(PORT, entry) in files, entry
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax",
                       "walk_these_ways_tpu"):
                bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad
