"""Tests of the port that need an NVIDIA GPU (marker `gpu`).

They build the control-step kernel with nvcc and launch it, so they skip on a
machine without a CUDA device.  Run them on the card with
    python -m pytest tests/test_torch_gpu.py -m gpu -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv, make_generator
from walk_these_ways_tpu_torch.go1_config import mob_train_cfg
from walk_these_ways_tpu_torch.ops import megastep
from walk_these_ways_tpu_torch.physics import engine

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda", 0)


def _call(env, state):
    _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
    return engine.megakernel_args(
        env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
        state.motor_strengths, env.torque_limits, ctrl,
        env.cfg.control.decimation, lam_in)


def test_kernel_matches_plain_version_on_the_card(cuda):
    """|kernel - plain| <= 2e-4 + 2e-4 |plain| on every output (float32;
    fused multiply-adds and another summation order in the kernel)."""
    n = 256
    env = LeggedRobotEnv(mob_train_cfg(n), device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    for _ in range(10):
        state, *_ = env.step(state, torch.randn((n, 12), generator=gen,
                                                device=cuda))
    args, kwargs = _call(env, state)
    assert args[-1] is not None and float(args[-1].abs().max()) > 0
    # with the cross-step seed (the main path), and without it: the first
    # substep then cold-starts at the full iteration count
    for call_args in (args, args[:-1] + (None,)):
        before = megastep.launches
        out_k = megastep.control_step(*call_args, **kwargs)
        torch.cuda.synchronize()
        assert megastep.launches == before + 1
        out_r = megastep.control_step_reference(*call_args, **kwargs)
        for a, b in zip(out_k, out_r):
            a, b = a[..., :n].cpu().numpy(), b[..., :n].cpu().numpy()
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_wrapper_raises_for_what_the_kernel_does_not_cover(cuda):
    n = 128
    env = LeggedRobotEnv(mob_train_cfg(n), device=cuda)
    state, _ = env.reset(make_generator(0, cuda))
    args, kwargs = _call(env, state)
    normals = torch.zeros((28, 3, args[6].shape[-1]), device=cuda)
    with pytest.raises(NotImplementedError):
        megastep.control_step(*args[:5], normals, *args[6:], **kwargs)
    with pytest.raises(NotImplementedError):
        megastep.control_step(*args, **dict(kwargs, control_type="P"))
    with pytest.raises(ValueError):
        megastep.control_step(*args[:6], args[6][:, :64], *args[7:], **kwargs)
