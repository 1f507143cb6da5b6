"""Rough terrain in the port vs the JAX package, on the CPU.

- `Terrain.lookup` (bilinear height and unit normal from the corner-packed
  field) against JAX's on a random field, queries inside and far outside it:
  within 1e-6 (heights up to 0.5 m, normals of unit length; both sides
  float32, the normal's norm summed in another order).
- `envs/terrain.build` gives the same heightfield bit for bit.
- The heightfield branch of `build_pallas_env_inputs` (heights + radius and
  normals sampled at the cache's contact points) against JAX's, from a JAX
  reset state converted leaf by leaf: rtol 1e-5 / atol 1e-6; the padded
  lanes of the normals are +z.
- The slice as a whole: the port's exact rough route (per substep one
  control-step launch of one substep on a fresh cache with fresh terrain
  samples, the general-normal plain version) against the JAX package's
  dense XLA env (`conftest.xla_physics`, `reuse_matrices=False`: FK, M^-1
  and the contact solve rebuilt before every substep, heights and normals
  sampled at the FK points), N = 8, 3 control steps.  Both compute the same
  thing in two formulations: rtol 1e-4 / atol 1e-5, the floors that the
  readings below needed stated beside them.
- The port's default rough route (the control-step plain version, warm
  start off) against its per-substep rough route (torque model + cache +
  4 dynamics substeps): reuse mode samples heights and normals once per
  control step and the routes advance the contact points differently, so
  they are held at the JAX package's own tolerances for its two routes
  (tests/test_pallas_megastep.py: 2e-3 on the base pose, 4e-3 on q).

The terrain is the JAX package's rough-slope test setup (2 x 2 tiles of
4 m, tests/test_pallas_dynamics.py), whose normals are far from +z.
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
from walk_these_ways_tpu.envs import terrain as j_terrain
from walk_these_ways_tpu.physics import engine as j_engine

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import go1_env as t_env
from walk_these_ways_tpu_torch.envs import terrain as t_terrain
from walk_these_ways_tpu_torch.physics import engine as t_engine
from walk_these_ways_tpu_torch.utils import convert

from test_torch_env import _to_numpy_state
from test_torch_util import assert_close, t

torch.set_num_threads(1)
N = 8
PHYS_LEAVES = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
               "q", "qd")


def _rough(cfg, **sim):
    """The rough-slope 2 x 2 tile setup, noise off, on either package's
    Cfg (the two are field for field the same dataclasses)."""
    terr = dataclasses.replace(
        cfg.terrain, mesh_type="heightfield", num_rows=2, num_cols=2,
        terrain_length=4.0, terrain_width=4.0,
        terrain_proportions=(0.0, 1.0, 0.0, 0.0, 0.0),
        teleport_robots=False, curriculum=False, center_robots=False)
    return dataclasses.replace(
        cfg, terrain=terr,
        noise=dataclasses.replace(cfg.noise, add_noise=False),
        sim=dataclasses.replace(cfg.sim, **sim))


# -- lookup -------------------------------------------------------------------


def _terrains(h, hs=0.1, origin=(-1.0, -2.0)):
    j = j_engine.make_heightfield_terrain(h, hs, origin)
    tp = t_engine.make_heightfield_terrain(h, hs, origin, device="cpu")
    np.testing.assert_array_equal(tp.corners.numpy(), np.asarray(j.corners))
    return j, tp


@pytest.mark.parametrize("where", ["in_range", "far_outside"])
def test_lookup_matches_jax(where):
    rng = np.random.RandomState(0)
    h = rng.uniform(-0.3, 0.5, (64, 80)).astype(np.float32)
    j, tp = _terrains(h)
    if where == "in_range":
        x = rng.uniform(-1.5, 5.5, (64, 64)).astype(np.float32)
        y = rng.uniform(-2.5, 6.0, (64, 64)).astype(np.float32)
    else:
        x = np.array([-100.0, 100.0, -100.0, 100.0, 2.0], np.float32)
        y = np.array([-100.0, -100.0, 100.0, 100.0, 300.0], np.float32)
    hj, nj = j.lookup(jnp.asarray(x), jnp.asarray(y))
    ht, nt = tp.lookup(t(x), t(y))
    assert ht.shape == x.shape and nt.shape == x.shape + (3,)
    assert_close(ht, hj, 0, 1e-6)
    assert_close(nt, nj, 0, 1e-6)
    assert bool(torch.isfinite(ht).all())
    assert_close(torch.linalg.norm(nt, dim=-1), np.ones(x.shape), 0, 1e-6)
    if where == "in_range":
        # the field is not flat here: the normals lean
        assert float(nt[..., 2].min()) < 0.9


def test_flat_lookup_is_plus_z():
    flat = t_engine.flat_terrain("cpu")
    x = torch.zeros(5)
    h, n = flat.lookup(x, x)
    assert float(h.abs().max()) == 0.0
    assert torch.equal(n, torch.tensor([[0.0, 0.0, 1.0]] * 5))


@pytest.mark.parametrize("which", ["rough_slope_2x2", "rough_train_cfg"])
def test_heightfield_is_bit_equal_to_jax(which):
    if which == "rough_train_cfg":
        tc, jc = t_cfg.rough_train_cfg(64), j_cfg.rough_train_cfg(64)
    else:
        tc, jc = _rough(t_cfg.mob_train_cfg(N)), _rough(
            j_cfg.mob_train_cfg(N))
    a = t_terrain.build(tc.terrain, seed=0)
    b = j_terrain.build(jc.terrain, seed=0)
    np.testing.assert_array_equal(np.asarray(a.height), np.asarray(b.height))
    assert a.horizontal_scale == b.horizontal_scale
    assert tuple(a.origin_xy) == tuple(b.origin_xy)
    assert float(np.abs(a.height).max()) > 0.0


# -- the env on a heightfield ------------------------------------------------


@pytest.fixture(scope="module")
def rough_envs():
    """The JAX env on its dense exact XLA path on the rough 2 x 2 tiles,
    reset once (jitted); the port's env on its exact control-step route
    with the converted state."""
    cfg_j = xla_physics(_rough(j_cfg.mob_train_cfg(N),
                               reuse_matrices=False))
    envj = j_env.LeggedRobotEnv(cfg_j)
    assert envj.terrain.corners is not None
    sj, _ = jax.jit(envj.reset)(jax.random.PRNGKey(0))
    envt = t_env.LeggedRobotEnv(
        _rough(t_cfg.mob_train_cfg(N), reuse_matrices=False), device="cpu")
    assert envt.rough and envt.terrain.corners is not None
    st = convert.env_state_from_numpy(
        _to_numpy_state(sj), t_env.make_generator(0, "cpu"), device="cpu")
    return envj, envt, sj, st


def test_env_terrain_and_origins_match_jax(rough_envs):
    envj, envt, _, _ = rough_envs
    np.testing.assert_array_equal(envt.terrain.height.numpy(),
                                  np.asarray(envj.terrain.height))
    np.testing.assert_array_equal(envt.env_origins.numpy(),
                                  np.asarray(envj.env_origins))


def test_heightfield_env_inputs_match_jax(rough_envs):
    envj, envt, sj, st = rough_envs
    block = 16                                   # 8 padded lanes
    gravity = sj.gravity_offset + jnp.asarray([0.0, 0.0, -9.8])
    dyn_j = j_engine.DynamicsParams(
        payload=sj.payloads, com_displacement=sj.com_displacements,
        friction=sj.friction_coeffs, restitution=sj.restitutions,
        gravity=jnp.tile(gravity[None, :], (N, 1)))
    em_j, rh_j, _, _, _, n_j = j_engine.build_pallas_env_inputs(
        envj.model, sj.phys, dyn_j, envj.terrain, block)
    em_t, rh_t, _, _, _, n_t = t_engine.build_pallas_env_inputs(
        envt.model, st.phys, envt.dynamics_params(st)[1], envt.terrain,
        block)
    assert tuple(n_t.shape) == (28, 3, block)
    assert_close(em_t.p_cp_t, em_j.p_cp_t, 1e-5, 1e-6)
    assert_close(rh_t, rh_j, 1e-5, 1e-6)
    assert_close(n_t[..., :N], np.asarray(n_j)[..., :N], 1e-5, 1e-6)
    # padded lanes: +z, where the JAX package leaves zeros it never reads
    assert torch.equal(n_t[..., N:], torch.tensor([0.0, 0.0, 1.0])[
        None, :, None].expand(28, 3, block - N))
    # the robots stand on slopes: normals far from +z
    assert float(n_t[:, 2, :N].min()) < 0.95
    # flat ground gives no normals
    assert t_engine.build_pallas_env_inputs(
        envt.model, st.phys, envt.dynamics_params(st)[1],
        t_engine.flat_terrain("cpu"), block)[-1] is None


# Floors beside rtol 1e-4 for the exact rough route against the JAX dense
# XLA env, each with the largest excess over rtol 1e-4 measured in the three
# steps (x86-64 CPU, one thread); every other leaf stays within atol 1e-5.
# qd (up to 28 rad/s; two algorithms, M^-1 entries up to 1e2): 1.69e-5.
ATOL_QD = 5e-5
# reward: the XLA env takes the feet from FK on the final state, the route
# from the points its last substep advanced at velocity level (7.5e-4 m
# apart, as on flat ground); the foot terms move rewards of 1e-6 to 2e-3 by
# up to 1.47e-5 beyond rtol 1e-4.
ATOL_REWARD = 5e-5


@pytest.fixture(scope="module")
def exact_rough_steps(rough_envs):
    envj, envt, sj, st = rough_envs
    step_j = jax.jit(envj.step)
    rs = np.random.RandomState(9)
    out = []
    for _ in range(3):
        a = (0.5 * rs.randn(N, 12)).astype(np.float32)
        sj, oj, rj, dj, _ = step_j(sj, jnp.asarray(a))
        st, ot, rt, dt_, _ = envt.step(st, torch.from_numpy(a))
        out.append(((sj, oj, rj, dj), (st, ot, rt, dt_)))
    return out


@pytest.mark.parametrize("key", PHYS_LEAVES + ("obs", "reward", "done"))
def test_exact_rough_route_matches_jax_xla_env(exact_rough_steps, key):
    for k, ((sj, oj, rj, dj), (st, ot, rt, dt_)) in enumerate(
            exact_rough_steps):
        msg = f"{key} step {k}"
        if key == "obs":
            assert_close(ot["obs"], oj["obs"], 1e-4, 1e-5, err_msg=msg)
        elif key == "reward":
            assert_close(rt, rj, 1e-4, ATOL_REWARD, err_msg=msg)
        elif key == "done":
            np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
        else:
            assert_close(getattr(st.phys, key), getattr(sj.phys, key), 1e-4,
                         ATOL_QD if key == "qd" else 1e-5, err_msg=msg)
    # contacts engaged on the slopes
    assert float(exact_rough_steps[-1][1][0].contact_forces.abs().max()) > 1.0


def test_default_rough_route_matches_substep_rough_route(rough_envs):
    """The control-step plain version with normals (K4b's arithmetic, warm
    start off) against torque model + cache + 4 dynamics substeps with
    normals (K3b's), from one state, 2 control steps."""
    st = rough_envs[3]
    cfg = _rough(t_cfg.mob_train_cfg(N), contact_warm_start=False,
                 contact_cross_step_warm_start=False)
    env_m = t_env.LeggedRobotEnv(cfg, device="cpu")
    env_s = t_env.LeggedRobotEnv(dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, megastep=False)), device="cpu")
    sm = st._replace(rng=t_env.make_generator(5, "cpu"))
    ss = st._replace(rng=t_env.make_generator(5, "cpu"))
    rs = np.random.RandomState(5)
    for _ in range(2):
        a = torch.from_numpy((0.4 * rs.randn(N, 12)).astype(np.float32))
        sm, om, rm, dm, _ = env_m.step(sm, a)
        ss, os_, rs_, ds, _ = env_s.step(ss, a)
    assert_close(sm.phys.base_pos, ss.phys.base_pos, 0, 2e-3)
    assert_close(sm.phys.base_quat, ss.phys.base_quat, 0, 2e-3)
    assert_close(sm.phys.q, ss.phys.q, 0, 4e-3)
    assert_close(sm.phys.qd, ss.phys.qd, 0, 5e-2)
    assert_close(sm.torques, ss.torques, 0, 1e-2)
    assert torch.equal(sm.lag_buffer, ss.lag_buffer)
    assert torch.equal(sm.joint_pos_target, ss.joint_pos_target)
    assert_close(sm.joint_pos_err_last, ss.joint_pos_err_last, 0, 2e-3)
    assert_close(sm.joint_vel_last, ss.joint_vel_last, 0, 5e-2)
    assert_close(sm.foot_velocities, ss.foot_velocities, 0, 5e-2)
    assert_close(sm.contact_forces, ss.contact_forces, 1e-2, 2.0)
    assert_close(rm, rs_, 0, 1e-2)
    assert float(sm.contact_forces.abs().max()) > 1.0


def test_exact_rough_route_matches_substep_exact_rough_route(rough_envs):
    """The port's two exact rough routes from one state: D control-step
    launches of one substep each (K4b's arithmetic, cold) against torque
    model + cache + one dynamics substep per substep (K3b's)."""
    envt, st = rough_envs[1], rough_envs[3]
    env_s = t_env.LeggedRobotEnv(
        _rough(t_cfg.mob_train_cfg(N), megastep=False, reuse_matrices=False),
        device="cpu")
    sx = st._replace(rng=t_env.make_generator(5, "cpu"))
    ss = st._replace(rng=t_env.make_generator(5, "cpu"))
    rs = np.random.RandomState(6)
    for k in range(2):
        a = torch.from_numpy((0.5 * rs.randn(N, 12)).astype(np.float32))
        sx, ox, rx, dx, _ = envt.step(sx, a)
        ss, os_, rs_, ds, _ = env_s.step(ss, a)
        for leaf in PHYS_LEAVES:
            assert_close(getattr(sx.phys, leaf), getattr(ss.phys, leaf),
                         1e-4, ATOL_QD if leaf == "qd" else 1e-5,
                         err_msg=f"{leaf} step {k}")
        assert torch.equal(dx, ds)
