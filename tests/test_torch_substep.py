"""The per-substep physics route of the port vs the JAX package, on the CPU.

Kernel wrappers (`build_contact_cache`, `contact_substep`,
`dynamics_substep`; on CPU tensors they take their plain versions) against
the JAX kernel BODIES run eagerly on jnp arrays (`_cache_kernel`,
`_substep_kernel`, `_dyn_substep_kernel` with a box per output ref — no
`pallas_call`, no interpret mode): rtol 1e-5 / atol 1e-6 for the cache and
the dynamics, one decade more after 16 chained solver sweeps.

`physics_substep_cached` and whole env control steps on the per-substep route
against the JAX package's dense XLA path (`conftest.xla_physics`,
`reuse_matrices=True`): the same mathematics in another formulation (dense
N-major einsums against env-minor sparsity-aware sums), so rtol 1e-4 /
atol 1e-5 on every leaf over the first two control steps.  The third step
(12 substeps of contact in) keeps those values except for joint and base
angular velocities, whose floor is `ATOL_V3`; forces (impulses / dt) get
`ATOL_F`.  Each floor stands beside the largest error measured on an x86-64
CPU, one thread.

Inputs come from a numpy seed and from one JAX `env.reset`.
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
from walk_these_ways_tpu.models.robot import go1 as j_go1
from walk_these_ways_tpu.ops import pallas_contact as j_pc
from walk_these_ways_tpu.ops import pallas_dynamics as j_pd
from walk_these_ways_tpu.physics import engine as j_engine

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import go1_env as t_env
from walk_these_ways_tpu_torch.models.robot import go1 as t_go1
from walk_these_ways_tpu_torch.ops import contact as t_pc
from walk_these_ways_tpu_torch.ops import dynamics as t_pd
from walk_these_ways_tpu_torch.physics import engine as t_engine
from walk_these_ways_tpu_torch.utils import convert

from test_torch_env import _to_numpy_state
from test_torch_util import assert_close, random_dyn_np, random_phys_np, t

torch.set_num_threads(1)
N = 8
RTOL, ATOL = 1e-5, 1e-6
STATICS = dict(dt=0.005, relaxation=0.4, baumgarte=0.2, slop=0.002,
               max_depen=1.0, bounce_thresh=0.5)
# Floor for joint and base angular velocities in the third control step: a
# 1e-7 difference in an impulse reaches them through M^-1, whose entries are
# up to 1e2, and 12 substeps of contact carry it on.  Measured beyond
# rtol 1e-4: qd 5.1e-6 (|qd| up to 28), base_ang_vel 4.3e-6; in the first two
# steps both stay below 1e-6 and are held to 1e-5 like every other leaf.
ATOL_V3 = 2e-5
# Exact mode is compared with another algorithm (`engine.physics_substep`
# builds and solves densely before every substep): qd measured 2.0e-5 beyond
# rtol 1e-4 after one control step, every other leaf below 1e-6.
ATOL_V_EXACT = 5e-5
# Forces are impulses / dt (x 200), up to 134 N here; measured: every nonzero
# force within rtol 1e-4, so the floor only covers forces below 1 N.
ATOL_F = 1e-4


def _atol(leaf, k):
    return ATOL_V3 if k >= 2 and leaf in ("qd", "base_ang_vel") else 1e-5
PHYS_LEAVES = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
               "q", "qd")


class _Box:
    """Stands in for an output ref: keeps what the kernel body stores."""

    def __setitem__(self, idx, value):
        self.value = value


def _quiet(cfg):
    return dataclasses.replace(
        cfg, noise=dataclasses.replace(cfg.noise, add_noise=False))


@pytest.fixture(scope="module")
def envs():
    """The JAX env on its dense XLA path (reuse mode), reset once; the
    port's env on the per-substep route with the converted state."""
    cfg_j = xla_physics(_quiet(j_cfg.mob_train_cfg(N)))
    assert cfg_j.sim.reuse_matrices
    envj = j_env.LeggedRobotEnv(cfg_j)
    sj, _ = jax.jit(envj.reset)(jax.random.PRNGKey(0))
    cfg_t = _quiet(t_cfg.mob_train_cfg(N))
    cfg_t = dataclasses.replace(cfg_t, sim=dataclasses.replace(
        cfg_t.sim, megastep=False))
    envt = t_env.LeggedRobotEnv(cfg_t, device="cpu")
    st = convert.env_state_from_numpy(
        _to_numpy_state(sj), t_env.make_generator(0, "cpu"), device="cpu")
    return envj, envt, sj, st


def _jax_inputs(ph, dy):
    model = j_go1()
    state = j_engine.PhysicsState(**{k: jnp.asarray(v) for k, v in ph.items()})
    dyn = j_engine.DynamicsParams(**{k: jnp.asarray(v) for k, v in dy.items()})
    em, rh_t, mu_t, e_t, g_t, n_t = j_engine.build_pallas_env_inputs(
        model, state, dyn, None, block=N)
    assert n_t is None
    return model, em, rh_t, mu_t, e_t, g_t


@pytest.fixture(scope="module")
def world(envs):
    """Env-minor kernel inputs from the JAX package (block = N: no padding):
    two numpy-seeded states and the state of the JAX env after its reset."""
    out = {}
    for name, seed, height in (("reset", 0, 0.34), ("stance", 1, 0.27)):
        out[name] = _jax_inputs(random_phys_np(N, seed, height),
                                random_dyn_np(N, seed))
    sj = envs[2]
    grav = np.asarray(sj.gravity_offset) + np.array([0, 0, -9.8], np.float32)
    out["env_reset"] = _jax_inputs(
        {k: np.asarray(v) for k, v in sj.phys._asdict().items()},
        dict(payload=np.asarray(sj.payloads),
             com_displacement=np.asarray(sj.com_displacements),
             friction=np.asarray(sj.friction_coeffs),
             restitution=np.asarray(sj.restitutions),
             gravity=np.tile(grav[None], (N, 1)).astype(np.float32)))
    return out


def _topology(model):
    anc = np.asarray(model.anc_dof_body).astype(bool)
    anc_p = anc[:, np.asarray(model.cp_body)].T
    return anc, anc_p


def _vlim(model):
    return np.concatenate([np.full(3, 25.0), np.full(3, 15.0),
                           np.asarray(model.dof_vel_limit)]
                          ).astype(np.float32)[:, None]


def _jax_cache(model, em):
    _, anc_p = _topology(model)
    boxes = [_Box(), _Box()]
    j_pc._cache_kernel(jnp.asarray(anc_p, jnp.float32), em.Sw_t, em.Sv_t,
                       em.Minv_t, em.r_t, *boxes, P=28, nv=18, eps=1e-6)
    return boxes[0].value, boxes[1].value


WHICH = ["reset", "stance", "env_reset"]


@pytest.mark.parametrize("which", WHICH)
def test_build_contact_cache_matches_jax_kernel_body(world, which):
    model, em, *_ = world[which]
    _, anc_p = _topology(model)
    Jj, Wj = _jax_cache(model, em)
    before = t_pc.cache_launches
    Jt, Wt = t_pc.build_contact_cache(
        t(anc_p.astype(np.float32)), t(em.Sw_t), t(em.Sv_t), t(em.Minv_t),
        t(em.r_t))
    assert t_pc.cache_launches == before      # CPU tensors launch no kernel
    assert tuple(Jt.shape) == (28, 3, 18, N) and tuple(Wt.shape) == (28, 9, N)
    assert_close(Jt, Jj, RTOL, ATOL)
    assert_close(Wt, Wj, RTOL, ATOL)


def _falling_gv(seed):
    rs = np.random.RandomState(seed)
    gv = rs.uniform(-1, 1, (18, N)).astype(np.float32)
    gv[5] -= 1.0      # falling: contacts engage
    return gv


@pytest.mark.parametrize("which", WHICH)
def test_contact_substep_matches_jax_kernel_body(world, which):
    model, em, rh_t, mu_t, e_t, g_t = world[which]
    Jj, Wj = _jax_cache(model, em)
    gv = _falling_gv(11)
    vlim = _vlim(model)
    kw = dict(num_iters=16, **STATICS)
    boxes = [_Box() for _ in range(3)]
    j_pc._substep_kernel(Jj, Wj, em.Minv_t, em.p_cp_t, jnp.asarray(gv), rh_t,
                         mu_t, e_t, jnp.asarray(vlim), *boxes, P=28, nv=18,
                         **kw)
    before = t_pc.substep_launches
    outs = t_pc.contact_substep(
        t(Jj), t(Wj), t(em.Minv_t), t(em.p_cp_t), t(gv), t(rh_t), t(mu_t),
        t(e_t), t(vlim), **kw)
    assert t_pc.substep_launches == before
    if which != "reset":
        assert float(np.abs(np.asarray(boxes[2].value)).max()) > 1e-3
    # 16 chained sweeps amplify rounding: one decade above the single-call
    # tolerance
    for a, b in zip(outs, boxes):
        assert_close(a, b.value, 1e-4, 1e-5)


def _normals(seed):
    """(28, 3, N) unit surface normals tilted up to about 25 deg off +z."""
    rs = np.random.RandomState(seed)
    n = np.concatenate([rs.uniform(-0.45, 0.45, (28, 2, N)),
                        np.ones((28, 1, N))], axis=1)
    return (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)


def _dyn_substep_both(world, which, contact=True, normals=None):
    model, em, rh_t, mu_t, e_t, g_t = world[which]
    anc, anc_p = _topology(model)
    Jj, Wj = _jax_cache(model, em)
    rs = np.random.RandomState(5)
    tau = rs.uniform(-5, 5, (18, N)).astype(np.float32)
    tau[:6] = 0.0
    gv = _falling_gv(13)
    vlim = _vlim(model)
    kw = dict(num_iters=16, contact=contact, **STATICS)
    boxes = [_Box() for _ in range(3)]
    j_pd._dyn_substep_kernel(
        em.Sw_t, em.Sv_t, em.A_t, em.B_t, em.m_t, em.Minv_t, g_t,
        jnp.asarray(tau), jnp.asarray(gv), Jj, Wj, em.p_cp_t, rh_t, mu_t,
        e_t, jnp.asarray(vlim),
        *([] if normals is None else [jnp.asarray(normals)]), *boxes,
        anc=anc, joint_body=np.asarray(model.joint_body),
        groups=tuple(j_pc.point_dof_groups(anc_p)), nb=13, nj=12, nv=18,
        flat=normals is None, **kw)
    tm = t_go1()
    args = [t(x) for x in (em.Sw_t, em.Sv_t, em.A_t, em.B_t, em.m_t,
                           em.Minv_t, g_t, tau, gv, Jj, Wj, em.p_cp_t, rh_t,
                           mu_t, e_t, vlim)]
    topo = dict(anc=tm.anc_dof_body, joint_body=tm.joint_body,
                cp_body=tm.cp_body)
    before = (t_pd.launches, t_pd.normal_launches)
    outs = t_pd.dynamics_substep(
        *args, None if normals is None else t(normals), **topo, **kw)
    assert (t_pd.launches, t_pd.normal_launches) == before
    return outs, [b.value for b in boxes], args, topo, kw


@pytest.mark.parametrize("which", WHICH)
def test_dynamics_substep_matches_jax_kernel_body(world, which):
    outs, refs, *_ = _dyn_substep_both(world, which)
    if which != "reset":
        assert float(np.abs(np.asarray(refs[2])).max()) > 1e-3
    for a, b in zip(outs, refs):
        assert_close(a, b, 1e-4, 1e-5)


def test_dynamics_substep_without_contact_and_with_normals(world):
    outs, refs, args, topo, kw = _dyn_substep_both(world, "stance",
                                                   contact=False)
    # no solver sweeps: the single-call tolerance (accelerations x dt)
    assert_close(outs[0], refs[0], RTOL, 1e-5)
    assert torch.equal(outs[1], args[11])
    assert float(outs[2].abs().max()) == 0.0
    # K2's result on the free velocity of the plain dynamics is K3's
    gv_free = outs[0]
    gv2, pcp2, lam2 = t_pc.contact_substep(
        args[9], args[10], args[5], args[11], gv_free, *args[12:16],
        **{k: v for k, v in kw.items() if k != "contact"})
    full = t_pd.dynamics_substep(*args, **topo, **dict(kw, contact=True))
    for a, b in zip((gv2, pcp2, lam2), full):
        assert_close(a, b, 1e-5, 1e-6)
    # K3b's arithmetic: the plain version with surface normals against the
    # JAX kernel body with flat=False, at the tolerance of 16 chained sweeps
    outs_n, refs_n, *_ = _dyn_substep_both(world, "stance",
                                           normals=_normals(21))
    lam_n = np.asarray(refs_n[2])
    assert float(np.abs(lam_n[:, :2]).max()) > 1e-3     # off the vertical
    for a, b in zip(outs_n, refs_n):
        assert_close(a, b, 1e-4, 1e-5)
    assert float((outs_n[2] - full[2]).abs().max()) > 1e-3


def test_wrappers_do_not_fall_back_off_the_cpu(world):
    """A tensor that is neither on the CPU nor on a CUDA device raises; a
    CUDA-less call without device="cpu" raises; no wrapper's CUDA branch
    names its plain version."""
    import inspect
    outs, refs, args, topo, kw = _dyn_substep_both(world, "reset")
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):
        t_pd.dynamics_substep(*meta, **topo, **kw)
    with pytest.raises(ValueError):                      # K3b's operands
        t_pd.dynamics_substep(*meta, torch.zeros(28, 3, N, device="meta"),
                              **topo, **kw)
    with pytest.raises(ValueError):
        t_pc.contact_substep(*[meta[i] for i in (9, 10, 5, 11, 8, 12, 13, 14,
                                                 15)],
                             **{k: v for k, v in kw.items() if k != "contact"})
    with pytest.raises(ValueError):
        t_pc.build_contact_cache(torch.zeros(28, 18, device="meta"), meta[0],
                                 meta[1], meta[5], meta[11])
    assert not torch.cuda.is_available()
    cfg = t_cfg.mob_train_cfg(4)
    cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, megastep=False))
    with pytest.raises((RuntimeError, AssertionError)):
        t_env.LeggedRobotEnv(cfg)            # device defaults to "cuda"
    for fn, plain in ((t_pc.build_contact_cache, "cache_core"),
                      (t_pc.contact_substep, "contact_core"),
                      (t_pd.dynamics_substep, "dynamics_substep_reference")):
        head, tail = inspect.getsource(fn).split('if dev.type != "cuda"', 1)
        assert plain in head and plain not in tail
        for banned in ("torch.matmul", "torch.compile", " @ ", "einsum"):
            assert banned not in tail
    # K3 and K3b: one launch, the normals' flag packed into it by
    # kernel_operands (which names no plain path either), each variant
    # counted on its own
    tail = inspect.getsource(t_pd.dynamics_substep).split(
        'if dev.type != "cuda"', 1)[1]
    assert "kernel_operands(" in tail
    assert "normal_launches += 1" in tail and "launches += 1" in tail
    packing = inspect.getsource(t_pd.kernel_operands)
    assert "KERNEL_THREADS, n_t is not None)" in packing
    assert 'ins.append(("n_t", n_t, (P, 3, Npad)))' in packing
    for banned in ("dynamics_substep_reference", "contact_core", "dyn_core(",
                   "torch.matmul", " @ "):
        assert banned not in packing, banned


def _dyn_of(env, s):
    return env.dynamics_params(s)[1]


def _jax_dyn(sj):
    gravity = sj.gravity_offset + jnp.asarray([0.0, 0.0, -9.8])
    return j_engine.DynamicsParams(
        payload=sj.payloads, com_displacement=sj.com_displacements,
        friction=sj.friction_coeffs, restitution=sj.restitutions,
        gravity=jnp.tile(gravity[None, :], (N, 1)))


def test_physics_substep_cached_matches_jax_xla_path(envs):
    envj, envt, sj, st = envs
    rs = np.random.RandomState(4)
    tau = rs.uniform(-8, 8, (N, 12)).astype(np.float32)
    cache_j = jax.jit(lambda phys, dyn: j_engine.build_dynamics_cache(
        envj.model, envj.sim_params, phys, dyn))(sj.phys, _jax_dyn(sj))
    substep_j = jax.jit(
        lambda phys, tau, dyn, cache, pcp: j_engine.physics_substep_cached(
            envj.model, envj.sim_params, phys, tau, dyn, envj.terrain, cache,
            pcp))
    cache_t = t_engine.build_dynamics_cache(
        envt.model, envt.sim_params, st.phys, _dyn_of(envt, st), envt.terrain)
    assert tuple(cache_t.pallas_ops.J_t.shape) == (28, 3, 18, 256)
    assert cache_t.pallas_ops.block == 256
    # the padded lanes hold zeros in Minv and eps on W's diagonal
    assert float(cache_t.pallas_ops.Minv_t[..., N:].abs().max()) == 0.0
    assert_close(cache_t.pallas_ops.W_t[:, 8, N:], np.full((28, 256 - N), 1e-6),
                 0, 1e-12)
    pj, pcp_j = sj.phys, cache_j.p_cp
    pt, pcp_t = st.phys, None
    for k in range(2):
        pj, cinfo, pcp_j = substep_j(pj, jnp.asarray(tau), _jax_dyn(sj),
                                     cache_j, pcp_j)
        pt, lam_t, pcp_t = t_engine.physics_substep_cached(
            envt.model, envt.sim_params, pt, t(tau), _dyn_of(envt, st),
            envt.terrain, cache_t, pcp_t)
        # no NaN leaves a padded lane
        assert bool(torch.isfinite(lam_t).all() & torch.isfinite(pcp_t).all())
        for leaf in PHYS_LEAVES:
            assert_close(getattr(pt, leaf), getattr(pj, leaf), 1e-4, 1e-5,
                         err_msg=f"{leaf} substep {k}")
        assert_close(t_pc.from_env_minor(pcp_t, N), pcp_j, 1e-4, 1e-5)
        forces = t_engine.contact_report_from_lam_t(
            envt.model, lam_t, envt.sim_params.dt, N)
        assert_close(forces.report_forces, cinfo.report_forces, 1e-4, ATOL_F)
    assert float(np.abs(np.asarray(cinfo.report_forces)).max()) > 1.0
    # without use_pallas_contact the cache is the dense route's N-major
    # one, the JAX XLA path's own (tests/test_torch_dense.py holds its
    # substeps); a substep refuses a cache of the other route
    dense_params = dataclasses.replace(envt.sim_params,
                                       use_pallas_contact=False)
    dense = t_engine.build_dynamics_cache(envt.model, dense_params, st.phys,
                                          _dyn_of(envt, st))
    assert dense.pallas_ops is None and tuple(dense.J.shape) == (N, 28, 3, 18)
    for name in ("J", "p_cp", "Sw", "Sv"):
        assert_close(getattr(dense, name), getattr(cache_j, name), RTOL,
                     ATOL, err_msg=name)
    # W = J M^-1 J^T through M^-1 (entries up to 3e2): measured 2.7e-6
    assert_close(dense.W, cache_j.W, RTOL, 1e-5)
    with pytest.raises(ValueError):
        t_engine.physics_substep_cached(
            envt.model, dense_params, st.phys, t(tau), _dyn_of(envt, st),
            envt.terrain, cache_t)


@pytest.fixture(scope="module")
def stepped(envs):
    envj, envt, sj, st = envs
    rs = np.random.RandomState(9)
    steps = []
    step_j = jax.jit(envj.step)
    for _ in range(3):
        a = (0.5 * rs.randn(N, 12)).astype(np.float32)
        sj, oj, rj, dj, ij = step_j(sj, jnp.asarray(a))
        st, ot, rt, dt_, it = envt.step(st, torch.from_numpy(a))
        steps.append(((sj, oj, rj, dj, ij), (st, ot, rt, dt_, it)))
    return steps


@pytest.mark.parametrize("leaf", PHYS_LEAVES)
def test_env_control_steps_match_jax_xla_env_physics(stepped, leaf):
    for k, ((sj, *_), (st, *_)) in enumerate(stepped):
        assert_close(getattr(st.phys, leaf), getattr(sj.phys, leaf), 1e-4,
                     _atol(leaf, k), err_msg=f"step {k}")


@pytest.mark.parametrize("key", ["obs", "privileged_obs", "reward", "done",
                                 "torques", "contact_forces", "foot_positions",
                                 "lag_buffer", "joint_pos_target",
                                 "joint_pos_err_last", "contact_lam_t"])
def test_env_control_steps_match_jax_xla_env(stepped, key):
    for k, ((sj, oj, rj, dj, ij), (st, ot, rt, dt_, it)) in enumerate(stepped):
        if key in ("obs", "privileged_obs"):
            assert_close(ot[key], oj[key], 1e-4, 1e-5, err_msg=f"step {k}")
        elif key == "reward":
            assert_close(rt, rj, 1e-4, 1e-5)
        elif key == "done":
            np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
        elif key == "torques":
            # measured: within rtol 1e-4 alone in all three steps
            assert_close(it.torques, ij.torques, 1e-4, 1e-5)
        elif key == "contact_forces":
            assert_close(st.contact_forces, sj.contact_forces, 1e-4, ATOL_F)
        else:
            # `contact_lam_t` is left untouched by this route in both
            assert_close(getattr(st, key), getattr(sj, key), 1e-4, 1e-5,
                         err_msg=f"{key} step {k}")


def _port_envs(**sim):
    cfg = _quiet(t_cfg.mob_train_cfg(N))
    cold = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, contact_warm_start=False, **sim))
    sub = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, megastep=False, **sim))
    return cold, sub


def test_substep_route_matches_control_step_route_cold_started(envs):
    """The port's two routes from one state and the same actions: the
    whole-control-step plain version with warm start off (16 sweeps from
    zero in every substep) against torque model + K1 + 4 x K3.  The lag
    buffer's per-substep shift must equal its decimation-unrolled form."""
    cold, sub = _port_envs()
    e4 = t_env.LeggedRobotEnv(cold, device="cpu")
    es = envs[1]
    s = envs[3]
    rs = np.random.RandomState(2)
    for k in range(3):
        a = torch.from_numpy((0.5 * rs.randn(N, 12)).astype(np.float32))
        s4, o4, r4, d4, _ = e4.step(s._replace(rng=t_env.make_generator(5, "cpu")), a)
        ss, os_, rs_, ds, _ = es.step(s._replace(rng=t_env.make_generator(5, "cpu")), a)
        for leaf in PHYS_LEAVES:
            assert_close(getattr(ss.phys, leaf), getattr(s4.phys, leaf).numpy(),
                         1e-4, 1e-5, err_msg=f"{leaf} step {k}")
        assert torch.equal(ss.lag_buffer, s4.lag_buffer)
        assert torch.equal(ss.joint_pos_target, s4.joint_pos_target)
        assert_close(os_["obs"], o4["obs"].numpy(), 1e-4, 1e-5)
        assert_close(ss.contact_forces, s4.contact_forces.numpy(), 1e-4,
                     ATOL_F)
        assert torch.equal(ds, d4)
        s = s4


def test_exact_mode_and_p_control_on_the_substep_route(envs):
    """Exact mode (a fresh cache and fresh FK points before every substep)
    against the JAX package's exact XLA path, `engine.physics_substep` x 4;
    it must also differ from reuse mode.  P control once against the JAX
    XLA env in reuse mode."""
    envj, envt, sj, st = envs
    _, sub_exact = _port_envs(reuse_matrices=False)
    ee = t_env.LeggedRobotEnv(sub_exact, device="cpu")
    a = torch.from_numpy(
        (0.5 * np.random.RandomState(6).randn(N, 12)).astype(np.float32))
    se, *_ = ee.step(st._replace(rng=t_env.make_generator(5, "cpu")), a)
    sr, *_ = envt.step(st._replace(rng=t_env.make_generator(5, "cpu")), a)
    assert float((se.phys.q - sr.phys.q).abs().max()) > 1e-5
    cfg_jx = dataclasses.replace(envj.cfg, sim=dataclasses.replace(
        envj.cfg.sim, reuse_matrices=False))
    sjx, *_ = jax.jit(j_env.LeggedRobotEnv(cfg_jx).step)(
        sj, jnp.asarray(a.numpy()))
    for leaf in PHYS_LEAVES:
        assert_close(getattr(se.phys, leaf), getattr(sjx.phys, leaf), 1e-4,
                     ATOL_V_EXACT if leaf == "qd" else 1e-5, err_msg=leaf)
    assert_close(se.contact_forces, sjx.contact_forces, 1e-4, ATOL_F)
    # the JAX XLA path takes the feet from FK on the final state, this
    # route from the points the last substep advanced at velocity level
    # (measured difference 7.5e-4 m)
    assert_close(se.foot_positions, sjx.foot_positions, 1e-4, 1e-3)

    cfg_jp = xla_physics(_quiet(j_cfg.mob_train_cfg(N)))
    cfg_jp = dataclasses.replace(cfg_jp, control=dataclasses.replace(
        cfg_jp.control, control_type="P"))
    cfg_tp = dataclasses.replace(envt.cfg, control=dataclasses.replace(
        envt.cfg.control, control_type="P"))
    envjp = j_env.LeggedRobotEnv(cfg_jp)
    envtp = t_env.LeggedRobotEnv(cfg_tp, device="cpu")
    sjp, *_ = jax.jit(envjp.step)(sj, jnp.asarray(a.numpy()))
    stp, _, _, _, info = envtp.step(
        st._replace(rng=t_env.make_generator(5, "cpu")), a)
    assert_close(info.torques, sjp.torques, 1e-4, 1e-5)
    assert_close(stp.phys.q, sjp.phys.q, 1e-4, 1e-5)
    assert_close(stp.phys.base_pos, sjp.phys.base_pos, 1e-4, 1e-5)
    assert_close(stp.phys.qd, sjp.phys.qd, 1e-4, 1e-5)
    # P control keeps no actuator history
    assert torch.equal(stp.joint_pos_err_last, st.joint_pos_err_last)
