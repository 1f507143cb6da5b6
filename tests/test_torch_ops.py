"""ops / models helpers of the port vs the JAX package, same numpy inputs.

Tolerance rtol 1e-5 / atol 1e-6: float32 on both sides, same formulas; only
the order inside sums and small matrix products differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu.models import actuator_net as j_act
from walk_these_ways_tpu.models import robot as j_robot
from walk_these_ways_tpu.ops import linalg as j_la
from walk_these_ways_tpu.ops import pallas_contact as j_pc
from walk_these_ways_tpu.ops import pallas_megastep as j_pm
from walk_these_ways_tpu.ops import quat as j_q

from walk_these_ways_tpu_torch.models import actuator_net as t_act
from walk_these_ways_tpu_torch.models import robot as t_robot
from walk_these_ways_tpu_torch.ops import contact as t_pc
from walk_these_ways_tpu_torch.ops import linalg as t_la
from walk_these_ways_tpu_torch.ops import megastep as t_pm
from walk_these_ways_tpu_torch.ops import quat as t_q
from walk_these_ways_tpu_torch.utils import convert

from test_torch_util import assert_close, t

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6


def _quats(rs, n):
    q = rs.randn(n, 4).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


QUAT_CASES = {
    "quat_mul": lambda rs: (_quats(rs, 32), _quats(rs, 32)),
    "quat_apply": lambda rs: (_quats(rs, 32), rs.randn(32, 3).astype(np.float32)),
    "quat_rotate_inverse": lambda rs: (_quats(rs, 32), rs.randn(32, 3).astype(np.float32)),
    "quat_apply_yaw": lambda rs: (_quats(rs, 32), rs.randn(32, 3).astype(np.float32)),
    "quat_conjugate": lambda rs: (_quats(rs, 32),),
    "quat_to_rotmat": lambda rs: (_quats(rs, 32),),
    "yaw_quat": lambda rs: (_quats(rs, 32),),
    "normalize": lambda rs: (rs.randn(32, 3).astype(np.float32),),
    "skew": lambda rs: (rs.randn(32, 3).astype(np.float32),),
    "wrap_to_pi": lambda rs: (rs.uniform(-10, 10, 64).astype(np.float32),),
    "quat_from_angle_axis": lambda rs: (rs.uniform(-3, 3, 32).astype(np.float32),
                                        rs.randn(32, 3).astype(np.float32)),
    "quat_from_euler_xyz": lambda rs: tuple(
        rs.uniform(-3, 3, 32).astype(np.float32) for _ in range(3)),
}


@pytest.mark.parametrize("name", sorted(QUAT_CASES))
def test_quat_op_matches_jax(name):
    args = QUAT_CASES[name](np.random.RandomState(0))
    out_j = getattr(j_q, name)(*[jnp.asarray(a) for a in args])
    out_t = getattr(t_q, name)(*[t(a) for a in args])
    assert_close(out_t, out_j, RTOL, ATOL)


def test_quat_integrate_and_euler_match_jax():
    rs = np.random.RandomState(1)
    q = _quats(rs, 32)
    w = rs.randn(32, 3).astype(np.float32)
    w[0] = 0.0                      # the 0/0 guard at rest
    assert_close(t_q.quat_integrate(t(q), t(w), 0.005),
                 j_q.quat_integrate(jnp.asarray(q), jnp.asarray(w), 0.005),
                 RTOL, ATOL)
    for a, b in zip(t_q.quat_to_euler_xyz(t(q)),
                    j_q.quat_to_euler_xyz(jnp.asarray(q))):
        assert_close(a, b, 1e-4, 1e-5)   # atan2/asin near their branch points
    assert_close(t_q.quat_identity((3,), device="cpu"), j_q.quat_identity((3,)))


def _spd(rs, n, k):
    a = rs.randn(n, k, k).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + k * np.eye(k, dtype=np.float32)


def test_inv3_and_inv_spd6_match_jax():
    rs = np.random.RandomState(2)
    m3, m6 = _spd(rs, 16, 3), _spd(rs, 16, 6)
    assert_close(t_la.inv3(t(m3)), j_la.inv3(jnp.asarray(m3)), RTOL, ATOL)
    assert_close(t_la.inv3(t(m3), 1e-3), j_la.inv3(jnp.asarray(m3), 1e-3),
                 RTOL, ATOL)
    assert_close(t_la.inv_spd6(t(m6)), j_la.inv_spd6(jnp.asarray(m6)),
                 RTOL, ATOL)


def test_mass_matrix_inverse_matches_jax_and_inverts():
    rs = np.random.RandomState(3)
    M = _spd(rs, 8, 18)
    # legs couple only through the base: zero the cross-leg joint blocks
    for a in range(4):
        for b in range(4):
            if a != b:
                M[:, 6 + 3 * a:9 + 3 * a, 6 + 3 * b:9 + 3 * b] = 0.0
    out_t = t_la.mass_matrix_inverse(t(M))
    assert_close(out_t, j_la.mass_matrix_inverse(jnp.asarray(M)), 1e-4, 1e-6)
    eye = (out_t @ t(M)).numpy()
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(18), eye.shape),
                               atol=1e-3)


@pytest.mark.parametrize("shape,block", [((5, 3), 4), ((8, 2, 3), 8),
                                         ((16, 4, 12), 128), ((7,), 4)])
def test_env_minor_helpers_match_jax(shape, block):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    xt = t_pc.to_env_minor(t(x), block)
    xj = j_pc.to_env_minor(jnp.asarray(x), block)
    assert xt.is_contiguous()
    assert_close(xt, xj, 0, 0)
    assert_close(t_pc.from_env_minor(xt, shape[0]),
                 j_pc.from_env_minor(xj, shape[0]), 0, 0)
    assert_close(t_pc.from_env_minor(xt, shape[0]), x, 0, 0)


def test_robot_model_and_point_dof_groups_match_jax():
    mj, mt = j_robot.go1(), t_robot.go1()
    assert (mt.nb, mt.nj, mt.nv, mt.cp_body.shape[0]) == (13, 12, 18, 28)
    for f in ("parent", "mass", "com", "inertia", "joint_body", "joint_anchor",
              "joint_axis", "dof_lower", "dof_upper", "dof_effort",
              "dof_vel_limit", "feet_report_indices", "foot_body",
              "foot_offset", "cp_body", "cp_offset", "cp_radius",
              "cp_report_body", "cp_is_foot", "anc_dof_body", "subtree",
              "crba_conn", "crba_body"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f), f)
    assert mt.joint_names == mj.joint_names
    assert mt.report_body_names == mj.report_body_names
    anc_p = mt.anc_dof_body.astype(bool)[:, mt.cp_body].T
    groups = t_pc.point_dof_groups(anc_p)
    assert groups == j_pc.point_dof_groups(anc_p)
    assert groups[0] == (0, 8, None, None) and len(groups) == 5
    from walk_these_ways_tpu_torch.go1_config import go1_cfg
    cfg = go1_cfg()
    angles = dict(cfg.init_state.default_joint_angles)
    assert_close(t_robot.default_dof_pos(mt, angles, device="cpu"),
                 j_robot.default_dof_pos(mj, angles), 0, 0)
    for a, b in zip(t_robot.pd_gains(mt, dict(cfg.control.stiffness),
                                     dict(cfg.control.damping), device="cpu"),
                    j_robot.pd_gains(mj, dict(cfg.control.stiffness),
                                     dict(cfg.control.damping))):
        assert_close(a, b, 0, 0)


def test_topology_header_lists_the_robot():
    h = t_pm.topology_header(t_robot.go1(), 32, 6)
    for line in ("#define MS_NB 13", "#define MS_NJ 12", "#define MS_NV 18",
                 "#define MS_P 28", "#define MS_GMAX 3", "#define MS_H 32",
                 "MS_ANC[234]", "MS_PT_LO[28]", "MS_PT_ANC[84]"):
        assert line in h, line
    nbytes, nops = t_pm.work_per_env(t_robot.go1(), 4, 3)
    assert 4000 < nbytes < 8000 and 1e5 < nops < 1e6


def test_cache_rebuild_ops_leaves_out_constants_and_static_zeros():
    """The exact-mode rebuild's count from the static structure lies below
    the elementwise arithmetic that the plain version dispatches for one env
    (that also builds the model's constants and multiplies by static
    zeros), and within a third of it."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from walk_these_ways_tpu_torch.physics import envminor as t_envminor
    arith = {"add", "sub", "mul", "div", "neg", "sin", "cos", "rsub"}
    dispatched = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.__name__.split(".")[0] in arith:
                dispatched.append(out.numel())
            return out

    m = t_robot.go1()
    one = torch.zeros(1)
    with Count():
        t_envminor.cache_columns(m, [one] * m.nj, [one] * 3 + [one + 1],
                                 [one] * 3, one, [one] * 3)
    n = t_pm.cache_rebuild_ops(m)
    assert 2 / 3 * sum(dispatched) < n < sum(dispatched)


def test_blockdiag_weights_and_actuator_net_match_jax():
    pj = j_act.load()
    pt = t_act.load(device="cpu")
    for a, b in zip(t_pm.blockdiag_actuator_weights(pt, device="cpu"),
                    j_pm.blockdiag_actuator_weights(pj)):
        assert_close(a, b, 0, 0)
    rs = np.random.RandomState(5)
    x = rs.randn(16, 12, 6).astype(np.float32)
    assert_close(t_act.apply(pt, t(x)), j_act.apply(pj, jnp.asarray(x)),
                 RTOL, ATOL)
    feats = [rs.randn(16, 12).astype(np.float32) for _ in range(6)]
    assert_close(t_act.eval_torques(pt, *[t(f) for f in feats]),
                 j_act.eval_torques(pj, *[jnp.asarray(f) for f in feats]),
                 RTOL, ATOL)
    # weights carried across as numpy
    pc_ = convert.actuator_net_from_numpy(
        {k: np.asarray(getattr(pj, k)) for k in pj._fields}, device="cpu")
    assert_close(pc_(t(x)), j_act.apply(pj, jnp.asarray(x)), RTOL, ATOL)
    # the block-diagonal form evaluates the same network
    W0b, b0b, W1b, b1b, W2b, b2b = t_pm.blockdiag_actuator_weights(
        pt, device="cpu")
    X = torch.cat([t(f).T for f in feats], dim=0)            # (72, B)
    h = t_pm._softsign(W0b @ X + b0b)
    h = t_pm._softsign(W1b @ h + b1b)
    assert_close((W2b @ h + b2b).T,
                 j_act.eval_torques(pj, *[jnp.asarray(f) for f in feats]),
                 RTOL, ATOL)
