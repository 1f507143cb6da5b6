"""The control-step route's exact mode (K5) and P control (K4c) at env level,
on the CPU, where the kernel wrappers take their plain versions.

- Exact mode (`sim.megastep` on, `sim.reuse_matrices` off: the whole cache
  rebuilt inside the control step before every substep) against the port's
  per-substep exact route (`sim.megastep` off: a fresh env-minor cache, K1's
  and K3's plain versions per substep), from one state with the same actions
  over two control steps.  The two compose the same mathematics from other
  pieces (torques N-major or env-minor, the actuator network per joint or
  block-diagonal): rtol 1e-4 / atol 1e-5 on every leaf.
- P control on `small_train_cfg(8)`, with motor offsets randomised so that
  their sign reaches the torques, against the JAX package's dense XLA env
  (`conftest.xla_physics`) under `jax.jit`, over two control steps.  The XLA
  path solves every substep cold with 16 sweeps, so the port's contact warm
  start is off: rtol 1e-4 / atol 1e-5 as in tests/test_torch_substep.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import xla_physics

from walk_these_ways_tpu import go1_config as j_cfg
from walk_these_ways_tpu.envs import go1_env as j_env

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import go1_env as t_env
from walk_these_ways_tpu_torch.ops import megastep as t_pm
from walk_these_ways_tpu_torch.physics import envminor as t_envminor
from walk_these_ways_tpu_torch.utils import convert

from test_torch_env import _to_numpy_state
from test_torch_util import assert_close

torch.set_num_threads(1)
N, STEPS = 8, 2
PHYS_LEAVES = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
               "q", "qd")
# forces are impulses / dt (x 200): the floor covers forces below 1 N
ATOL_F = 1e-4


def _quiet(cfg, **sim):
    return dataclasses.replace(
        cfg, noise=dataclasses.replace(cfg.noise, add_noise=False),
        sim=dataclasses.replace(cfg.sim, **sim))


def _actions(k):
    return torch.from_numpy(
        (0.5 * np.random.RandomState(40 + k).randn(N, 12)).astype(np.float32))


@pytest.fixture(scope="module")
def exact_runs():
    base = t_cfg.mob_train_cfg(N)
    env_k = t_env.LeggedRobotEnv(_quiet(base, reuse_matrices=False),
                                 device="cpu")
    env_s = t_env.LeggedRobotEnv(
        _quiet(base, reuse_matrices=False, megastep=False), device="cpu")
    s0, _ = env_k.reset(t_env.make_generator(0, "cpu"))
    sk = ss = s0
    steps = []
    for k in range(STEPS):
        builds = t_envminor.cache_builds
        launches = t_pm.exact_launches
        sk, ok, rk, dk, ik = env_k.step(
            sk._replace(rng=t_env.make_generator(7 + k, "cpu")), _actions(k))
        k_builds = t_envminor.cache_builds - builds
        ss, os_, rs_, ds, is_ = env_s.step(
            ss._replace(rng=t_env.make_generator(7 + k, "cpu")), _actions(k))
        steps.append(((sk, ok, rk, dk, ik), (ss, os_, rs_, ds, is_),
                      k_builds, t_pm.exact_launches - launches))
    return s0, steps


def test_exact_mode_control_step_route_makes_no_eager_cache_build(
        exact_runs):
    s0, steps = exact_runs
    for _, _, builds, launches in steps:
        assert builds == 0      # the cache is rebuilt inside the control step
        assert launches == 0    # CPU tensors launch no kernel
    # exact mode leaves the cross-step impulse seed alone
    assert torch.equal(steps[-1][0][0].contact_lam_t, s0.contact_lam_t)


@pytest.mark.parametrize("leaf", PHYS_LEAVES)
def test_exact_mode_control_step_route_matches_substep_route(exact_runs,
                                                             leaf):
    for k, ((sk, *_), (ss, *_), _, _) in enumerate(exact_runs[1]):
        assert_close(getattr(sk.phys, leaf), getattr(ss.phys, leaf).numpy(),
                     1e-4, 1e-5, err_msg=f"{leaf} step {k}")


@pytest.mark.parametrize("key", ["obs", "reward", "done", "torques",
                                 "contact_forces", "foot_positions",
                                 "joint_pos_err_last", "joint_vel_last"])
def test_exact_mode_control_step_route_matches_substep_route_env(exact_runs,
                                                                 key):
    for k, ((sk, ok, rk, dk, ik), (ss, os_, rs_, ds, is_), _, _) in \
            enumerate(exact_runs[1]):
        if key == "obs":
            assert_close(ok["obs"], os_["obs"].numpy(), 1e-4, 1e-5)
        elif key == "reward":
            assert_close(rk, rs_.numpy(), 1e-4, 1e-5)
        elif key == "done":
            assert torch.equal(dk, ds)
        elif key == "torques":
            assert_close(ik.torques, is_.torques.numpy(), 1e-4, 1e-5)
        elif key == "contact_forces":
            assert_close(sk.contact_forces, ss.contact_forces.numpy(), 1e-4,
                         ATOL_F)
            if k == STEPS - 1:
                assert float(ss.contact_forces.abs().max()) > 1.0
        else:
            assert_close(getattr(sk, key), getattr(ss, key).numpy(), 1e-4,
                         1e-5, err_msg=f"{key} step {k}")


@pytest.fixture(scope="module")
def p_runs():
    def small(cfg_fn, **sim):
        cfg = _quiet(cfg_fn(N), **sim)
        assert cfg.control.control_type == "P"
        return dataclasses.replace(cfg, domain_rand=dataclasses.replace(
            cfg.domain_rand, randomize_motor_offset=True))

    cfg_j = xla_physics(small(j_cfg.small_train_cfg))
    envj = j_env.LeggedRobotEnv(cfg_j)
    sj, _ = jax.jit(envj.reset)(jax.random.PRNGKey(0))
    envt = t_env.LeggedRobotEnv(small(t_cfg.small_train_cfg,
                                      contact_warm_start=False),
                                device="cpu")
    assert envt.cfg.sim.megastep and envt.cfg.sim.reuse_matrices
    st = convert.env_state_from_numpy(
        _to_numpy_state(sj), t_env.make_generator(0, "cpu"), device="cpu")
    assert float(st.motor_offsets.abs().max()) > 1e-3
    step_j = jax.jit(envj.step)
    steps = []
    for k in range(STEPS):
        launches = t_pm.p_launches
        sj, oj, rj, dj, ij = step_j(sj, jnp.asarray(_actions(k).numpy()))
        st, ot, rt, dt_, it = envt.step(st, _actions(k))
        assert t_pm.p_launches == launches
        steps.append(((sj, oj, rj, dj, ij), (st, ot, rt, dt_, it)))
    return steps


@pytest.mark.parametrize("leaf", PHYS_LEAVES)
def test_p_control_route_matches_jax_xla_env_physics(p_runs, leaf):
    for k, ((sj, *_), (st, *_)) in enumerate(p_runs):
        assert_close(getattr(st.phys, leaf), getattr(sj.phys, leaf), 1e-4,
                     1e-5, err_msg=f"{leaf} step {k}")


@pytest.mark.parametrize("key", ["obs", "reward", "done", "torques",
                                 "contact_forces", "joint_pos_target"])
def test_p_control_route_matches_jax_xla_env(p_runs, key):
    for k, ((sj, oj, rj, dj, ij), (st, ot, rt, dt_, it)) in \
            enumerate(p_runs):
        if key == "obs":
            assert_close(ot["obs"], oj["obs"], 1e-4, 1e-5)
        elif key == "reward":
            assert_close(rt, rj, 1e-4, 1e-5)
        elif key == "done":
            np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
        elif key == "torques":
            assert_close(it.torques, ij.torques, 1e-4, 1e-5)
        elif key == "contact_forces":
            assert_close(st.contact_forces, sj.contact_forces, 1e-4, ATOL_F)
        else:
            assert_close(getattr(st, key), getattr(sj, key), 1e-4, 1e-5,
                         err_msg=f"{key} step {k}")
    # P control keeps no actuator history
    assert float(p_runs[-1][1][0].joint_pos_err_last.abs().max()) == 0.0
