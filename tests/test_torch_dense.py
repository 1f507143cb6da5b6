"""The dense (N-major) engine path of the port vs the JAX package, on the CPU.

`SimParams.use_pallas_contact` off: the physics in stock torch ops on (N, ...)
tensors (physics/engine.py), no hand kernel; in the JAX package plain XLA.

- Each function of the path against its JAX counterpart on the same numpy
  inputs, one call: rtol 1e-5 / atol 1e-6 (the impulse sweeps too, the
  floors below stated beside what they measured).
- `physics_substep` and the N-major `build_dynamics_cache` +
  `physics_substep_cached` over one substep and over a 4-substep control
  step, from the JAX env's reset state and from a mid-stance state, on flat
  ground and on the 2 x 2 rough tiles of tests/test_torch_terrain.py; the
  foot state functions.
- The env (`conftest.xla_physics`, reuse and exact mode) against the JAX env
  from one converted reset state, 5 control steps.
- The 64-env zero-action golden of the dense path
  (tests/golden/traj_64env_zero_actions_xla.npz) from the JAX reset state.
- Mirrors of tests/test_physics_conservation.py and
  tests/test_physics_smoke.py on the port alone.

Inputs come from numpy seeds (tests/test_torch_util.py) and from one JAX
`env.reset`; random streams are not matched.  Every widened tolerance
stands beside the largest error measured on an x86-64 CPU, one thread.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import xla_physics

from walk_these_ways_tpu import go1_config as j_cfg
from walk_these_ways_tpu.envs import go1_env as j_env
from walk_these_ways_tpu.envs import terrain as j_terrain
from walk_these_ways_tpu.models import robot as j_robot
from walk_these_ways_tpu.physics import engine as j_engine

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import go1_env as t_env
from walk_these_ways_tpu_torch.learn import ppo as t_ppo
from walk_these_ways_tpu_torch.models import robot as t_robot
from walk_these_ways_tpu_torch.physics import engine as t_engine
from walk_these_ways_tpu_torch.physics import envminor as t_envminor
from walk_these_ways_tpu_torch.utils import convert

from test_torch_env import _to_numpy_state
from test_torch_terrain import _rough
from test_torch_util import assert_close, random_dyn_np, random_phys_np, t

torch.set_num_threads(1)
N = 8            # engine and function cases
N_ENV = 64       # env cases and the golden, from one JAX reset
RTOL, ATOL = 1e-5, 1e-6
PHYS_LEAVES = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
               "q", "qd")
GOLDEN_XLA = os.path.join(os.path.dirname(__file__), "golden",
                          "traj_64env_zero_actions_xla.npz")

J_GO1, T_GO1 = j_robot.go1(), t_robot.go1()
J_PARAMS, T_PARAMS = j_engine.SimParams(), t_engine.SimParams()


def _pair(cls_j, cls_t, arrays):
    """One NamedTuple of each package from the same numpy arrays."""
    return (cls_j(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            cls_t(**{k: t(v) for k, v in arrays.items()}))


def _phys_np(s, n=N):
    """numpy PhysicsState fields of the first `n` envs of a JAX state."""
    return {k: np.asarray(v)[:n] for k, v in s._asdict().items()}


# -- the rough 2 x 2 tiles ----------------------------------------------------


@pytest.fixture(scope="module")
def terrains():
    """(name -> (JAX terrain, port terrain)): flat ground and the rough
    slope tiles (8 m x 8 m, 0.1 m pitch, heights -0.05..0.23 m)."""
    arr = j_terrain.build(_rough(j_cfg.mob_train_cfg(N)).terrain, seed=0)
    return dict(
        flat=(j_engine.flat_terrain(), t_engine.flat_terrain("cpu")),
        rough=(j_engine.make_heightfield_terrain(
                   arr.height, arr.horizontal_scale, arr.origin_xy),
               t_engine.make_heightfield_terrain(
                   arr.height, arr.horizontal_scale, arr.origin_xy, "cpu")))


def _on_tiles(phys, terr_j, seed):
    """The states moved onto the rough tiles: base xy uniform in
    [1, 7] m, base height raised by the field's height there."""
    out = dict(phys)
    n = phys["base_pos"].shape[0]
    xy = np.random.RandomState(seed).uniform(1.0, 7.0, (n, 2))
    h, _ = terr_j.lookup(jnp.asarray(xy[:, 0], jnp.float32),
                         jnp.asarray(xy[:, 1], jnp.float32))
    out["base_pos"] = np.concatenate(
        [xy, phys["base_pos"][:, 2:] + np.asarray(h)[:, None]],
        axis=1).astype(np.float32)
    return out


# -- each function against the JAX function -----------------------------------


FUNCTIONS = ["axis_angle_rotmat", "forward_kinematics", "joint_twists",
             "inertia_blocks",
             "mass_matrix", "bias_forces", "body_twists",
             "mass_matrix_inverse_go1", "mass_matrix_inverse_box",
             "contact_solve", "impulse_iteration"]


def _jax_chain(sj, dj, terr_j):
    """The JAX path's stages on one batch, in one jitted program."""
    frames = j_engine.forward_kinematics(J_GO1, sj)
    Sw, Sv = j_engine.joint_twists(J_GO1, frames, sj.base_pos)
    blk = j_engine.inertia_blocks(J_GO1, frames, sj.base_pos, dj)
    gv = jnp.concatenate([sj.base_ang_vel, sj.base_lin_vel, sj.qd], axis=-1)
    Vw, Vv = j_engine.body_twists(J_GO1, Sw, Sv, gv)
    M = j_engine.mass_matrix(J_GO1, Sw, Sv, blk) + 1e-7 * jnp.eye(18)
    Minv = j_engine._mass_matrix_inverse(J_GO1, M)
    cache = j_engine.build_dynamics_cache(J_GO1, J_PARAMS, sj, dj)
    solve = j_engine._contact_solve(J_GO1, J_PARAMS, Minv, Sw, Sv, frames,
                                    sj.base_pos, gv, terr_j, dj, J_PARAMS.dt)
    return dict(frames=frames, Sw=Sw, Sv=Sv, blk=blk, gv=gv, Vw=Vw, Vv=Vv,
                M=M, Minv=Minv, cache=cache, solve=solve,
                bias=j_engine.bias_forces(J_GO1, Sw, Sv, Vw, Vv, blk, gv,
                                          dj.gravity),
                mass_matrix=j_engine.mass_matrix(J_GO1, Sw, Sv, blk))


@pytest.fixture(scope="module")
def chain(terrains):
    """The JAX chain on one random go1 batch (base 0.29 m above the rough
    tiles, feet on and in the slopes): each stage's outputs, which are the
    next stage's inputs."""
    terr_j = terrains["rough"][0]
    phys = _on_tiles(random_phys_np(N, 3, height=0.29), terr_j, 3)
    dyn = random_dyn_np(N, 3)
    sj, _ = _pair(j_engine.PhysicsState, t_engine.PhysicsState, phys)
    dj, _ = _pair(j_engine.DynamicsParams, t_engine.DynamicsParams, dyn)
    out = jax.jit(lambda s, d: _jax_chain(s, d, terr_j))(sj, dj)
    return dict(out, phys=phys, dyn=dyn, dj=dj)


def _frames_t(f):
    return t_engine.BodyFrames(*[t(x) for x in f])


def _blk_t(b):
    return t_engine.InertiaBlocks(*[t(x) for x in b])


def _function_case(case, c, terrains):
    """(port outputs, JAX outputs) of one function on the chain's inputs."""
    st = t_engine.PhysicsState(**{k: t(v) for k, v in c["phys"].items()})
    dt_ = t_engine.DynamicsParams(**{k: t(v) for k, v in c["dyn"].items()})
    Sw, Sv, blk = t(c["Sw"]), t(c["Sv"]), _blk_t(c["blk"])
    if case == "axis_angle_rotmat":
        axis = np.array([0.6, -0.0, 0.8])
        q = c["phys"]["q"][:, 1]
        return ((t_engine._axis_angle_rotmat(axis, t(q)),),
                (j_engine._axis_angle_rotmat(axis, jnp.asarray(q)),))
    if case == "forward_kinematics":
        return (tuple(t_engine.forward_kinematics(T_GO1, st)),
                tuple(c["frames"]))
    if case == "joint_twists":
        return (t_engine.joint_twists(T_GO1, _frames_t(c["frames"]),
                                      st.base_pos), (c["Sw"], c["Sv"]))
    if case == "inertia_blocks":
        return (tuple(t_engine.inertia_blocks(
            T_GO1, _frames_t(c["frames"]), st.base_pos, dt_)),
            tuple(c["blk"]))
    if case == "mass_matrix":
        return ((t_engine.mass_matrix(T_GO1, Sw, Sv, blk),),
                (c["mass_matrix"],))
    if case == "bias_forces":
        return ((t_engine.bias_forces(T_GO1, Sw, Sv, t(c["Vw"]), t(c["Vv"]),
                                      blk, t(c["gv"]), dt_.gravity),),
                (c["bias"],))
    if case == "body_twists":
        return (t_engine.body_twists(T_GO1, Sw, Sv, t(c["gv"])),
                (c["Vw"], c["Vv"]))
    if case == "mass_matrix_inverse_go1":
        return ((t_engine._mass_matrix_inverse(T_GO1, t(c["M"])),),
                (c["Minv"],))
    if case == "mass_matrix_inverse_box":
        # a single free body: no chains, the generic inverse
        rs = np.random.RandomState(5)
        a = rs.randn(N, 6, 6).astype(np.float32)
        M = (a @ a.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
        box_j, box_t = j_robot.box(), t_robot.box()
        return ((t_engine._mass_matrix_inverse(box_t, t(M)),),
                (j_engine._mass_matrix_inverse(box_j, jnp.asarray(M)),))
    terr_j, terr_t = terrains["rough"]
    if case == "contact_solve":
        return (t_engine._contact_solve(
            T_GO1, T_PARAMS, t(c["Minv"]), Sw, Sv, _frames_t(c["frames"]),
            st.base_pos, t(c["gv"]), terr_t, dt_, T_PARAMS.dt), c["solve"])
    # impulse sweeps on the N-major cache's J, M^-1 J^T and W, with normals
    # and targets of the tiles and a random active set
    cache = c["cache"]
    rs = np.random.RandomState(6)
    P = J_GO1.cp_body.shape[0]
    _, n_srf = terr_j.lookup(cache.p_cp[..., 0], cache.p_cp[..., 1])
    target = rs.uniform(0.0, 0.4, (N, P)).astype(np.float32)
    mu = 0.5 * (c["dyn"]["friction"][:, None] + 1.0)
    active = rs.uniform(size=(N, P)) < 0.5
    gv = c["gv"] + rs.uniform(-1, 1, (N, 18)).astype(np.float32)
    args = (cache.J, cache.MinvJT_p, cache.W, n_srf, target, mu, active, gv)
    return (t_engine._impulse_iteration(T_PARAMS, *[t(a) for a in args]),
            jax.jit(lambda *a: j_engine._impulse_iteration(J_PARAMS, *a))(
                *[jnp.asarray(a) for a in args]))


# Floors of the cases that chain products, beside their largest errors
# beyond rtol 1e-5 (x86-64 CPU, one thread):
# - the contact solve and the impulse sweeps: 16 chained sweeps of float32
#   sums in another order, through M^-1 (entries up to 1e2) into joint
#   velocities of up to 30 rad/s; measured 1.5e-5 (solve, dv), 9.2e-6
#   (sweeps, gv); impulses within 1e-6;
# - M^-1 (entries up to 2.9e2, a closed form of 3x3 and Schur inverses):
#   measured 1.25e-5 (1.8e-5 relative, at an entry of 0.7).
FLOORS = {"contact_solve": 5e-5, "impulse_iteration": 5e-5,
          "mass_matrix_inverse_go1": 5e-5}


@pytest.mark.parametrize("case", FUNCTIONS)
def test_function_matches_jax(chain, terrains, case):
    out, ref = _function_case(case, chain, terrains)
    assert len(out) == len(ref)
    for i, (a, b) in enumerate(zip(out, ref)):
        assert tuple(a.shape) == tuple(np.asarray(b).shape), (case, i)
        assert_close(a, b, RTOL, FLOORS.get(case, ATOL),
                     err_msg=f"{case} output {i}")
    if case == "contact_solve":
        # contacts engaged on the slopes
        assert float(out[1].abs().max()) > 1.0


# -- engine steps against JAX ----------------------------------------------------


@pytest.fixture(scope="module")
def jax_steps():
    """JAX substep functions, jitted once per (route, terrain)."""
    fns = {}

    def get(route, terrain):
        key = (route, id(terrain))
        if key not in fns:
            if route == "exact":
                fns[key] = jax.jit(lambda s, tau, dyn: j_engine.physics_substep(
                    J_GO1, J_PARAMS, s, tau, dyn, terrain))
            else:
                fns[key] = jax.jit(
                    lambda s, tau, dyn, cache, pcp:
                    j_engine.physics_substep_cached(
                        J_GO1, J_PARAMS, s, tau, dyn, terrain, cache, pcp))
        return fns[key]

    get.cache = jax.jit(lambda s, dyn: j_engine.build_dynamics_cache(
        J_GO1, J_PARAMS, s, dyn))
    return get


def _run_substeps(route, sj, st, dj, dt_, terr_j, terr_t, jax_steps, taus):
    """Both packages' substeps from one state, one torque set each; a list
    of ((port state, port contact info), (JAX state, JAX info)) per
    substep, and the caches."""
    out, caches = [], None
    if route == "cached":
        cj = jax_steps.cache(sj, dj)
        ct = t_engine.build_dynamics_cache(T_GO1, T_PARAMS, st, dt_, terr_t)
        pj, pt = cj.p_cp, None
        caches = (ct, cj)
    for tau in taus:
        if route == "exact":
            sj, ij = jax_steps("exact", terr_j)(sj, jnp.asarray(tau), dj)
            st, it = t_engine.physics_substep(T_GO1, T_PARAMS, st, t(tau),
                                              dt_, terr_t)
        else:
            sj, ij, pj = jax_steps("cached", terr_j)(
                sj, jnp.asarray(tau), dj, cj, pj)
            st, it, pt = t_engine.physics_substep_cached(
                T_GO1, T_PARAMS, st, t(tau), dt_, terr_t, ct, pt)
        out.append(((st, it, pt if route == "cached" else None),
                    (sj, ij, pj if route == "cached" else None)))
    return out, caches


@pytest.fixture(scope="module")
def engine_runs(env_runs, terrains, jax_steps):
    """4 substeps of each route from each start on each terrain."""
    starts = dict(reset=_phys_np(env_runs["start"].phys),
                  stance=_phys_np(env_runs["reuse"][-1][0].phys))
    dyn = random_dyn_np(N, 11)
    taus = [np.random.RandomState(20 + k).uniform(-8, 8, (N, 12))
            .astype(np.float32) for k in range(4)]
    runs = {}
    for route in ("exact", "cached"):
        for start, phys in starts.items():
            for terrain, (terr_j, terr_t) in terrains.items():
                sj, st = _pair(j_engine.PhysicsState, t_engine.PhysicsState,
                               _on_tiles(phys, terr_j, 12)
                               if terrain == "rough" else phys)
                dj, dt_ = _pair(j_engine.DynamicsParams,
                                t_engine.DynamicsParams, dyn)
                runs[route, start, terrain] = _run_substeps(
                    route, sj, st, dj, dt_, terr_j, terr_t, jax_steps, taus)
    return runs


# After 4 substeps the two float32 formulations drift apart through M^-1
# and the chained sweeps; the floor for the velocities is their largest
# excess over rtol 1e-4 (qd up to 30 rad/s) beside it: measured 2.2e-5
# (qd), every other leaf within 1e-5.  Forces are impulses / dt (x 200).
ATOL_V4, ATOL_F = 5e-5, 2e-3


@pytest.mark.parametrize("substeps", [1, 4])
@pytest.mark.parametrize("terrain", ["flat", "rough"])
@pytest.mark.parametrize("start", ["reset", "stance"])
@pytest.mark.parametrize("route", ["exact", "cached"])
def test_engine_step_matches_jax(engine_runs, route, start, terrain,
                                 substeps):
    """`physics_substep` (exact) and N-major `build_dynamics_cache` +
    `physics_substep_cached` (cached) after one substep and after a control
    step's four."""
    runs, caches = engine_runs[route, start, terrain]
    (st, it, pt), (sj, ij, pj) = runs[substeps - 1]
    for leaf in PHYS_LEAVES:
        atol = ATOL_V4 if substeps == 4 and leaf in (
            "qd", "base_ang_vel", "base_lin_vel") else 1e-5
        assert_close(getattr(st, leaf), getattr(sj, leaf), 1e-4, atol,
                     err_msg=f"{leaf} after {substeps}")
    assert_close(it.report_forces, ij.report_forces, 1e-4, ATOL_F)
    assert_close(it.foot_forces, ij.foot_forces, 1e-4, ATOL_F)
    if route == "cached":
        assert_close(pt, pj, 1e-4, 1e-5)
        if substeps == 1:
            ct, cj = caches
            for name in ("Sw", "Sv", "Minv", "J", "MinvJT_p", "W", "p_cp"):
                assert_close(getattr(ct, name), getattr(cj, name), RTOL,
                             FLOORS["mass_matrix_inverse_go1"],
                             err_msg=name)
            assert ct.pallas_ops is None
    # contacts engaged
    assert float(np.abs(np.asarray(runs[-1][1][1].report_forces)).max()) > 1.0


@pytest.mark.parametrize("which", ["foot_state_from_cache",
                                   "foot_positions_velocities"])
def test_foot_state_matches_jax(engine_runs, which):
    (st, _, pt), (sj, _, pj) = engine_runs["cached", "stance", "flat"][0][-1]
    if which == "foot_state_from_cache":
        ct, cj = engine_runs["cached", "stance", "flat"][1]
        out = t_engine.foot_state_from_cache(T_GO1, ct, st, pt)
        ref = j_engine.foot_state_from_cache(J_GO1, cj, sj, pj)
    else:
        out = t_engine.foot_positions_velocities(T_GO1, st)
        ref = jax.jit(lambda s: j_engine.foot_positions_velocities(
            J_GO1, s))(sj)
    assert_close(out[0], ref[0], 1e-4, 1e-5)
    assert_close(out[1], ref[1], 1e-4, 1e-4)


# -- the env against the JAX env -------------------------------------------------


def _golden_cfg(pkg, n):
    """The zero-action golden's config: mob_train_cfg, cold contact solves,
    the dense physics."""
    cfg = pkg.mob_train_cfg(n)
    return xla_physics(dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, contact_warm_start=False,
        contact_cross_step_warm_start=False)))


def _quiet(cfg, **sim):
    return dataclasses.replace(
        cfg, noise=dataclasses.replace(cfg.noise, add_noise=False),
        sim=dataclasses.replace(cfg.sim, **sim))


ENV_STEPS = 5


@pytest.fixture(scope="module")
def env_runs():
    """One JAX reset of the golden's config (N_ENV envs, its key); then
    ENV_STEPS control steps of random actions by both envs from the
    converted state, reuse and exact mode, observation noise off."""
    envj = j_env.LeggedRobotEnv(_golden_cfg(j_cfg, N_ENV))
    sj0, _ = jax.jit(envj.reset)(jax.random.PRNGKey(1234))
    start = convert.env_state_from_numpy(
        _to_numpy_state(sj0), t_env.make_generator(0, "cpu"), device="cpu")
    out = dict(start=sj0, start_t=start)
    for mode, reuse in (("reuse", True), ("exact", False)):
        ej = j_env.LeggedRobotEnv(_quiet(_golden_cfg(j_cfg, N_ENV),
                                         reuse_matrices=reuse))
        et = t_env.LeggedRobotEnv(_quiet(_golden_cfg(t_cfg, N_ENV),
                                         reuse_matrices=reuse), device="cpu")
        step_j = jax.jit(ej.step)
        rs = np.random.RandomState(9)
        sj, st = sj0, start._replace(rng=t_env.make_generator(5, "cpu"))
        builds = t_envminor.cache_builds
        steps = []
        for _ in range(ENV_STEPS):
            a = (0.5 * rs.randn(N_ENV, 12)).astype(np.float32)
            sj, oj, rj, dj, ij = step_j(sj, jnp.asarray(a))
            st, ot, rt, dt_, it = et.step(st, torch.from_numpy(a))
            steps.append(((sj, oj, rj, dj, ij), (st, ot, rt, dt_, it)))
        out[mode] = [s[0] for s in steps]
        out[mode + "_t"] = steps
        out[mode + "_builds"] = t_envminor.cache_builds - builds
    return out


ENV_KEYS = PHYS_LEAVES + ("obs", "reward", "done", "torques",
                          "contact_forces", "foot_positions",
                          "foot_velocities")
# Floors beside rtol 1e-4, with the largest excess over it measured over
# the 5 steps of both modes (x86-64 CPU, one thread; reuse / exact): joint
# velocities 9.98e-5 / 5.7e-5 and base angular velocities 3.0e-5 / 5.6e-5
# (M^-1 and the sweeps, as above), base linear velocities 4.1e-7;
# contact forces (impulses / dt) 6.6e-4 / 1.7e-3 N; foot velocities (J qd)
# 6.1e-6 / 3.8e-5; torques (the actuator network on those velocities)
# 1.1e-5 / 2.2e-5; observations 5.0e-6 / 2.8e-6, within the default 1e-5.
ENV_FLOORS = {"qd": 1e-4, "base_ang_vel": 1e-4, "base_lin_vel": 1e-4,
              "contact_forces": 5e-3, "foot_velocities": 1e-4,
              "torques": 5e-5}


@pytest.mark.parametrize("key", ENV_KEYS)
@pytest.mark.parametrize("mode", ["reuse", "exact"])
def test_env_matches_jax_env(env_runs, mode, key):
    for k, ((sj, oj, rj, dj, ij), (st, ot, rt, dt_, it)) in enumerate(
            env_runs[mode + "_t"]):
        msg = f"{mode} {key} step {k}"
        atol = ENV_FLOORS.get(key, 1e-5)
        if key in PHYS_LEAVES:
            assert_close(getattr(st.phys, key), getattr(sj.phys, key), 1e-4,
                         atol, err_msg=msg)
        elif key == "obs":
            assert_close(ot["obs"], oj["obs"], 1e-4, atol, err_msg=msg)
        elif key == "reward":
            assert_close(rt, rj, 1e-4, atol, err_msg=msg)
        elif key == "done":
            np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
        elif key == "torques":
            assert_close(it.torques, ij.torques, 1e-4, atol, err_msg=msg)
        else:
            assert_close(getattr(st, key), getattr(sj, key), 1e-4, atol,
                         err_msg=msg)
    # the dense route builds no env-minor cache and leaves the impulse
    # carry alone
    assert env_runs[mode + "_builds"] == 0
    assert torch.equal(st.contact_lam_t, env_runs["start_t"].contact_lam_t)
    assert float(st.contact_forces.abs().max()) > 1.0


# -- the golden --------------------------------------------------------------------


GOLDEN_STEPS = 30


def test_golden_trajectory_xla(env_runs):
    """The 64-env zero-action protocol from the JAX reset state converted.
    The first snapshot (10 steps) is held to 5e-5 (measured: q 1.4e-5 rad,
    base_pos 7.3e-7 m, reward 1.4e-8).  Later ones by statistics: the run
    is chaotic (a 1e-6 difference grows where a robot falls), and an env
    that terminates is reset from another random stream than the golden's.
    Over the envs this run did not reset (62 of 64), measured over the
    snapshots at 10, 20 and 30 steps: median |dq| 2.4e-7 rad, median
    |dpos| 0; 2 envs beyond 1e-3 (falling robots)."""
    z = np.load(GOLDEN_XLA)
    env = t_env.LeggedRobotEnv(_golden_cfg(t_cfg, N_ENV), device="cpu")
    s = env_runs["start_t"]
    pos, q, rew = [], [], []
    reset = torch.zeros(N_ENV, dtype=torch.bool)
    zeros = torch.zeros(N_ENV, 12)
    for i in range(GOLDEN_STEPS):
        s, _, r, done, _ = env.step(s, zeros)
        reset |= done
        if (i + 1) % 10 == 0:
            pos.append(s.phys.base_pos.numpy())
            q.append(s.phys.q.numpy())
            rew.append(r.numpy())
    k = len(pos)
    pos, q, rew = np.stack(pos), np.stack(q), np.stack(rew)
    np.testing.assert_allclose(pos[0], z["base_pos"][0], atol=5e-5)
    np.testing.assert_allclose(q[0], z["q"][0], atol=5e-5)
    np.testing.assert_allclose(rew[0], z["rew"][0], atol=5e-5)
    kept = ~reset.numpy()
    assert kept.sum() >= 0.8 * N_ENV
    dq = np.abs(q - z["q"][:k])[:, kept]                  # (k, envs, 12)
    dpos = np.abs(pos - z["base_pos"][:k])[:, kept]
    assert np.median(dq) < 1e-5 and np.median(dpos) < 1e-5
    # at most 10 % of the kept envs have drifted beyond 1e-3 anywhere
    drifted = (dq.max(axis=(0, 2)) > 1e-3) | (dpos.max(axis=(0, 2)) > 1e-3)
    assert drifted.sum() <= 0.1 * kept.sum(), int(drifted.sum())
    np.testing.assert_allclose(
        pos[:, kept, 2].mean(axis=1), z["base_pos"][:k, kept, 2].mean(axis=1),
        atol=1e-3)


# -- the env trains -----------------------------------------------------------------


def _go1_physics(n):
    """go1_cfg()'s physics (dense exact mode, its flat trimesh tiles, P
    control) on the MoB stack of `n` envs: go1_cfg() itself builds no env in
    either package (its 2.7M-bin command grid, the base_height reward scale
    without a term, 18 privileged observations against the 6 it makes)."""
    g = t_cfg.go1_cfg()
    return dataclasses.replace(t_cfg.mob_train_cfg(n), sim=g.sim,
                               terrain=g.terrain, control=g.control)


@pytest.mark.parametrize("which", ["go1_physics", "xla_mob_train"])
def test_dense_env_resets_steps_and_trains_on_cpu(which):
    cfg = (_go1_physics(N) if which == "go1_physics"
           else xla_physics(t_cfg.mob_train_cfg(N)))
    assert not cfg.sim.use_pallas_contact
    assert cfg.sim.reuse_matrices == (which == "xla_mob_train")
    env = t_env.LeggedRobotEnv(cfg, device="cpu")
    gen = t_env.make_generator(0, "cpu")
    ts = t_ppo.init_train_state(gen, env)
    fn = t_ppo.make_train_iteration(env, num_steps=2)
    state, obs = env.reset(gen)
    before = [p.detach().clone() for p in ts.policy.parameters()]
    state, obs, ts, m = fn(state, obs, ts)
    assert ts.iteration == 1
    assert np.isfinite(float(m.value_loss)) and np.isfinite(
        float(m.surrogate_loss))
    assert max(float((p.detach() - b).abs().max())
               for p, b in zip(ts.policy.parameters(), before)) > 0
    for v in (obs["obs"], state.phys.base_pos, state.foot_positions):
        assert bool(torch.isfinite(v).all())
    assert 0.15 < float(state.phys.base_pos[:, 2].mean()) < 0.45


# -- mirrors of tests/test_physics_conservation.py and test_physics_smoke.py --


def _go1_state(n, pos, quat=(0.0, 0.0, 0.0, 1.0), **kw):
    ddp = t_robot.default_dof_pos(T_GO1, dict(t_cfg.GO1_DEFAULT_JOINT_ANGLES),
                                  device="cpu")
    fields = dict(base_pos=torch.tensor([pos] * n),
                  base_quat=torch.tensor([quat] * n),
                  base_lin_vel=torch.zeros(n, 3),
                  base_ang_vel=torch.zeros(n, 3),
                  q=ddp.repeat(n, 1), qd=torch.zeros(n, 12))
    fields.update(kw)
    return t_engine.PhysicsState(**fields), ddp


def _momentum(model, state, dyn):
    """Linear momentum from the generalized state: sum_b m_b v_com_b."""
    frames = t_engine.forward_kinematics(model, state)
    Sw, Sv = t_engine.joint_twists(model, frames, state.base_pos)
    gv = torch.cat([state.base_ang_vel, state.base_lin_vel, state.qd], -1)
    Vw, Vv = t_engine.body_twists(model, Sw, Sv, gv)
    blk = t_engine.inertia_blocks(model, frames, state.base_pos, dyn)
    r = frames.com - state.base_pos[:, None, :]
    v_com = Vv + torch.cross(Vw, r, dim=-1)
    return torch.sum(blk.m[..., None] * v_com, dim=1).numpy()


def _energy(model, state, dyn):
    frames = t_engine.forward_kinematics(model, state)
    Sw, Sv = t_engine.joint_twists(model, frames, state.base_pos)
    gv = torch.cat([state.base_ang_vel, state.base_lin_vel, state.qd], -1)
    blk = t_engine.inertia_blocks(model, frames, state.base_pos, dyn)
    M = t_engine.mass_matrix(model, Sw, Sv, blk)
    return float(0.5 * torch.einsum("ni,nij,nj->n", gv, M, gv)[0])


def _fk_points(state):
    frames = t_engine.forward_kinematics(T_GO1, state)
    return t_engine._contact_points(T_GO1, frames)


@pytest.fixture(scope="module")
def stand_and_bounce():
    """One batch of 400 substeps: env 0 under PD control to the default
    pose from 0.32 m (the smoke test's stand), envs 1 and 2 dropped upside
    down from 0.5 m with restitution 0.9 and 0 (the conservation test's
    bounce; its 300 substeps are read).  Returns (final state, base
    vertical velocity per substep (400, 3), last contact info, default
    pose)."""
    st, ddp = _go1_state(3, [0.0, 0.0, 0.32])
    flip = [1.0, 0.0, 0.0, 0.0]
    st = st._replace(
        base_pos=torch.tensor([[0.0, 0.0, 0.32], [0.0, 0.0, 0.5],
                               [3.0, 0.0, 0.5]]),
        base_quat=torch.tensor([[0.0, 0.0, 0.0, 1.0], flip, flip]))
    dyn = t_engine.identity_dynamics_params(3, device="cpu")._replace(
        restitution=torch.tensor([0.0, 0.9, 0.0]))
    kd = torch.tensor([[0.5], [1.0], [1.0]])
    terr = t_engine.flat_terrain("cpu")
    vz, cis = [], None
    for _ in range(400):
        tau = 20.0 * (ddp - st.q) - kd * st.qd
        st, cis = t_engine.physics_substep(T_GO1, T_PARAMS, st, tau, dyn,
                                           terr)
        vz.append(st.base_lin_vel[:, 2].clone())
    return st, torch.stack(vz).numpy(), cis, ddp


def _airborne(seed):
    rs = np.random.RandomState(seed)
    return _go1_state(2, [0.0, 0.0, 50.0],
                      base_lin_vel=t(rs.uniform(-1, 1, (2, 3))),
                      base_ang_vel=t(rs.uniform(-2, 2, (2, 3))))[0]


def _momentum_under_gravity(_):
    """In free flight dP/dt = m_total g."""
    st = _airborne(0)
    params = t_engine.SimParams(contact_enabled=False)
    dyn = t_engine.identity_dynamics_params(2, gravity=(0.0, 0.0, -9.8),
                                            device="cpu")
    terr = t_engine.flat_terrain("cpu")
    p0 = _momentum(T_GO1, st, dyn)
    for _ in range(100):
        st, _ = t_engine.physics_substep(T_GO1, params, st,
                                         torch.zeros(2, 12), dyn, terr)
    expected = p0 + T_GO1.mass.sum() * np.array([0, 0, -9.8]) * 100 \
        * params.dt
    np.testing.assert_allclose(_momentum(T_GO1, st, dyn), expected,
                               rtol=2e-2, atol=2e-2)


def _airborne_joint_motion_momentum(_):
    """Legs flailing in the air, no gravity: internal forces cancel."""
    st = _airborne(1)
    params = t_engine.SimParams(contact_enabled=False)
    dyn = t_engine.identity_dynamics_params(2, gravity=(0.0, 0.0, 0.0),
                                            device="cpu")
    terr = t_engine.flat_terrain("cpu")
    p0 = _momentum(T_GO1, st, dyn)
    for i in range(60):
        # gentle torques: below the joint velocity clamp
        tau = 0.25 * float(np.sin(0.2 * i)) * torch.ones(2, 12)
        st, _ = t_engine.physics_substep(T_GO1, params, st, tau, dyn, terr)
    np.testing.assert_allclose(_momentum(T_GO1, st, dyn), p0, atol=0.15)


def _restitution_bounce(request):
    """The trunk box lands flat: e = 0.9 rebounds at most of the impact
    speed, e = 0 stops dead."""
    vz = request.getfixturevalue("stand_and_bounce")[1]
    bouncy, dead = vz[:300, 1], vz[:300, 2]
    assert np.isfinite(vz).all()
    assert bouncy.max() > 0.5 * abs(bouncy.min()), (bouncy.max(),
                                                   bouncy.min())
    assert dead.max() < 0.35, dead.max()


def _cached_substep_tracks_exact(_):
    """Reuse mode tracks exact mode over 5 control steps of 4 substeps."""
    n = 3
    st, ddp = _go1_state(n, [0.0, 0.0, 0.30],
                         base_lin_vel=torch.tensor([[0.3, 0.0, 0.0]] * n),
                         base_ang_vel=torch.tensor([[0.0, 0.0, 0.5]] * n))
    dyn = t_engine.identity_dynamics_params(n, device="cpu")
    terr = t_engine.flat_terrain("cpu")
    s_exact = s_cached = st
    for _ in range(5):
        cache = t_engine.build_dynamics_cache(T_GO1, T_PARAMS, s_cached, dyn)
        p_cp = cache.p_cp
        for _ in range(4):
            s_exact, _ = t_engine.physics_substep(
                T_GO1, T_PARAMS, s_exact,
                20.0 * (ddp - s_exact.q) - 0.5 * s_exact.qd, dyn, terr)
            s_cached, _, p_cp = t_engine.physics_substep_cached(
                T_GO1, T_PARAMS, s_cached,
                20.0 * (ddp - s_cached.q) - 0.5 * s_cached.qd, dyn, terr,
                cache, p_cp)
    assert_close(s_cached.base_pos, s_exact.base_pos.numpy(), 0, 0.02)
    assert_close(s_cached.q, s_exact.q.numpy(), 0, 0.05)


def _moving_state(n, seed, z, scale_v, scale_q, scale_qd, spread_xy):
    rs = np.random.RandomState(seed)
    st, _ = _go1_state(n, [0.0, 0.0, z])
    return st._replace(
        base_pos=st.base_pos + (t(rs.randn(n, 3)) if spread_xy else 0.0),
        base_lin_vel=t(scale_v * rs.randn(n, 3)),
        base_ang_vel=t(scale_v * rs.randn(n, 3)),
        q=st.q + t(scale_q * rs.randn(n, 12)),
        qd=t(scale_qd * rs.randn(n, 12)))


def _velocity_integrated_points_track_fk(_):
    """p' = p + dt J qd stays within 5 mm of FK over a control step."""
    st = _moving_state(4, 5, 0.4, 0.5, 0.1, 2.0, False)
    dyn = t_engine.identity_dynamics_params(4, device="cpu")
    cache = t_engine.build_dynamics_cache(T_GO1, T_PARAMS, st, dyn)
    assert_close(cache.p_cp, _fk_points(st).numpy(), 0, 1e-5)
    p_cp = cache.p_cp
    for _ in range(4):
        st, _, p_cp = t_engine.physics_substep_cached(
            T_GO1, T_PARAMS, st, torch.zeros(4, 12), dyn,
            t_engine.flat_terrain("cpu"), cache, p_cp)
    err = float((p_cp - _fk_points(st)).abs().max())
    assert err < 5e-3, f"contact point drift {err} m over one control step"


def _foot_state_from_cache_at_anchor(_):
    st = _moving_state(3, 7, 3.0, 1.0, 0.2, 1.0, True)
    dyn = t_engine.identity_dynamics_params(3, device="cpu")
    cache = t_engine.build_dynamics_cache(T_GO1, T_PARAMS, st, dyn)
    p_c, v_c = t_engine.foot_state_from_cache(T_GO1, cache, st, cache.p_cp)
    p_fk, v_fk = t_engine.foot_positions_velocities(T_GO1, st)
    assert_close(p_c, p_fk.numpy(), 0, 1e-5)
    assert_close(v_c, v_fk.numpy(), 0, 1e-4)


def _free_tumble_energy_bounded(_):
    """Zero torque and gravity, |w| = 20 rad/s, no clamps and no limit
    springs: the midpoint rule keeps the energy within 6 % over 1 s (50 m
    up: the contact solve, which would find no contact, is left out)."""
    model = dataclasses.replace(
        T_GO1, dof_vel_limit=np.full(12, 1e9), dof_lower=np.full(12, -1e9),
        dof_upper=np.full(12, 1e9))
    params = dataclasses.replace(t_engine.SimParams(), max_base_lin_vel=1e9,
                                 max_base_ang_vel=1e9, contact_enabled=False)
    dyn = t_engine.identity_dynamics_params(1, gravity=(0.0, 0.0, 0.0),
                                            device="cpu")
    ax = np.array([0.4, 0.7, 0.59])
    ax /= np.linalg.norm(ax)
    st, _ = _go1_state(1, [0.0, 0.0, 50.0], base_ang_vel=t((20.0 * ax)[None]))
    e0 = _energy(model, st, dyn)
    for _ in range(200):
        st, _ = t_engine.physics_substep(model, params, st, torch.zeros(1, 12),
                                         dyn, t_engine.flat_terrain("cpu"))
    e1 = _energy(model, st, dyn)
    assert np.isfinite(e1)
    assert e1 / e0 < 1.06, f"tumble energy grew {e1 / e0:.3f}x over 1 s"


MIRRORS = {f.__name__[1:]: f for f in (
    _momentum_under_gravity, _airborne_joint_motion_momentum,
    _restitution_bounce, _cached_substep_tracks_exact,
    _velocity_integrated_points_track_fk, _foot_state_from_cache_at_anchor,
    _free_tumble_energy_bounded)}


@pytest.mark.parametrize("case", list(MIRRORS))
def test_conservation_mirror(case, request):
    """tests/test_physics_conservation.py on the port, at its tolerances."""
    MIRRORS[case](request)


def _fk_feet_below_base(st, dyn, _):
    p_foot, v_foot = t_engine.foot_positions_velocities(T_GO1, st)
    p = p_foot[0].numpy()
    assert p.shape == (4, 3) and (p[:, 2] < 0.1).all()
    # FL, FR, RL, RR: x signs + + - -, y signs + - + -
    assert p[0, 0] > 0 and p[1, 0] > 0 and p[2, 0] < 0 and p[3, 0] < 0
    assert p[0, 1] > 0 and p[1, 1] < 0 and p[2, 1] > 0 and p[3, 1] < 0
    assert_close(v_foot, np.zeros(tuple(v_foot.shape)), 0, 1e-5)


def _mass_matrix_of(st, dyn):
    frames = t_engine.forward_kinematics(T_GO1, st)
    Sw, Sv = t_engine.joint_twists(T_GO1, frames, st.base_pos)
    blk = t_engine.inertia_blocks(T_GO1, frames, st.base_pos, dyn)
    return t_engine.mass_matrix(T_GO1, Sw, Sv, blk).numpy(), Sw, Sv, blk


def _mass_matrix_spd(st, dyn, _):
    M = _mass_matrix_of(st, dyn)[0]
    assert M.shape == (st.q.shape[0], 18, 18)
    np.testing.assert_allclose(M, np.swapaxes(M, -1, -2), atol=1e-4)
    assert np.linalg.eigvalsh(M[0]).min() > 0
    # translational block = total mass * I3
    np.testing.assert_allclose(M[0, 3:6, 3:6], T_GO1.mass.sum() * np.eye(3),
                               atol=1e-3)


def _mass_matrix_against_dense_oracle(st, dyn, _):
    """M_ij = sum_b anc_i anc_j S_i^T I_b S_j with dense 6x6 blocks, at a
    tilted base and a perturbed pose."""
    n = st.q.shape[0]
    quat = torch.tensor([[0.2, -0.1, 0.3, 0.95]] * n)
    st = st._replace(
        q=st.q + t(0.2 * np.random.RandomState(3).randn(n, 12)),
        base_quat=quat / quat.norm(dim=-1, keepdim=True))
    M, Sw, Sv, blk = _mass_matrix_of(st, dyn)
    B = blk.B.numpy()
    S6 = np.concatenate([Sw.numpy(), Sv.numpy()], axis=-1)     # (n, nv, 6)
    I6 = np.zeros((n, T_GO1.nb, 6, 6))
    I6[..., :3, :3] = blk.A.numpy()
    I6[..., :3, 3:] = B
    I6[..., 3:, :3] = np.swapaxes(B, -1, -2)
    I6[..., 3:, 3:] = blk.m.numpy()[..., None, None] * np.eye(3)
    anc = T_GO1.anc_dof_body
    M_ref = np.einsum("ib,jb,nik,nbkl,njl->nij", anc, anc, S6, I6, S6)
    np.testing.assert_allclose(M, M_ref, rtol=1e-4, atol=1e-4)


def _pd_stand(st, dyn, request):
    """PD control to the default pose settles standing on its feet."""
    s, _, cis, ddp = request.getfixturevalue("stand_and_bounce")
    z = float(s.base_pos[0, 2])
    assert 0.2 < z < 0.4, f"standing height {z}"
    assert float(torch.linalg.norm(s.base_lin_vel[0])) < 0.1
    fz = float(cis.foot_forces[0, :, 2].sum())
    weight = T_GO1.mass.sum() * 9.81
    assert abs(fz - weight) / weight < 0.25, f"support {fz} vs {weight}"
    assert float((s.q[0] - ddp).abs().max()) < 0.3


def _free_fall(st, dyn, _):
    """With no contacts (10 m up) the base accelerates at g."""
    st = st._replace(base_pos=st.base_pos + torch.tensor([0.0, 0.0, 10.0]))
    for _ in range(20):
        st, _ = t_engine.physics_substep(T_GO1, T_PARAMS, st,
                                         torch.zeros(st.q.shape[0], 12), dyn,
                                         t_engine.flat_terrain("cpu"))
    np.testing.assert_allclose(float(st.base_lin_vel[0, 2]),
                               -9.81 * 20 * T_PARAMS.dt, rtol=0.05)


SMOKE = {f.__name__[1:]: f for f in (
    _fk_feet_below_base, _mass_matrix_spd, _mass_matrix_against_dense_oracle,
    _pd_stand, _free_fall)}


@pytest.mark.parametrize("case", list(SMOKE))
def test_smoke_mirror(case, request):
    """tests/test_physics_smoke.py on the port, at its tolerances: 4 envs
    standing at 0.32 m in the default pose."""
    st, _ = _go1_state(4, [0.0, 0.0, 0.32])
    SMOKE[case](st, t_engine.identity_dynamics_params(4, device="cpu"),
                request)
