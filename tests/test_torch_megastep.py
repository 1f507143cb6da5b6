"""Plain PyTorch control-step cores vs the JAX functions, on the CPU.

`cache_core`, `dyn_core` and `contact_core` of the JAX package are plain jnp
functions: they are called directly.  The whole control step is held against
the JAX kernel BODY run eagerly: `_megastep_kernel` is called with jnp arrays
as its input "refs" (`x[:]` works on an array) and a small box class as each
output ref — no `pallas_call`, no interpret mode.

Tolerance: rtol 1e-5 / atol 1e-6 for one call — both sides are float32 and do
the same operations in the same order; only the order inside sums and matrix
products differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu.models import actuator_net as j_act
from walk_these_ways_tpu.models.robot import go1 as j_go1
from walk_these_ways_tpu.ops import pallas_contact as j_pc
from walk_these_ways_tpu.ops import pallas_dynamics as j_pd
from walk_these_ways_tpu.ops import pallas_megastep as j_pm
from walk_these_ways_tpu.physics import engine as j_engine

from walk_these_ways_tpu_torch.models import actuator_net as t_act
from walk_these_ways_tpu_torch.models.robot import go1 as t_go1
from walk_these_ways_tpu_torch.ops import contact as t_pc
from walk_these_ways_tpu_torch.ops import dynamics as t_pd
from walk_these_ways_tpu_torch.ops import megastep as t_pm
from walk_these_ways_tpu_torch.physics.envminor import EnvMinorCache

from test_torch_util import assert_close, random_dyn_np, random_phys_np, t

torch.set_num_threads(1)
N = 8
RTOL, ATOL = 1e-5, 1e-6
STATICS = dict(dt=0.005, relaxation=0.4, baumgarte=0.2, slop=0.002,
               max_depen=1.0, bounce_thresh=0.5)
OUT_NAMES = ("q", "qd", "pos", "quat", "lin", "ang", "pcp", "pcp_prev",
             "lam", "tau", "el", "ell", "vl", "vll")


class _Box:
    """Stands in for an output ref: keeps what the kernel body stores."""

    def __setitem__(self, idx, value):
        self.value = value


def _jax_inputs(seed, height):
    """Env-minor kernel inputs from the JAX package (block = N: no padding)."""
    model = j_go1()
    ph = random_phys_np(N, seed, height)
    dy = random_dyn_np(N, seed)
    state = j_engine.PhysicsState(**{k: jnp.asarray(v) for k, v in ph.items()})
    dyn = j_engine.DynamicsParams(**{k: jnp.asarray(v) for k, v in dy.items()})
    em, rh_t, mu_t, e_t, g_t, n_t = j_engine.build_pallas_env_inputs(
        model, state, dyn, None, block=N)
    assert n_t is None
    return model, ph, em, rh_t, mu_t, e_t, g_t


@pytest.fixture(scope="module")
def world():
    out = {}
    for name, seed, height in (("reset", 0, 0.34), ("stance", 1, 0.27)):
        out[name] = _jax_inputs(seed, height)
    return out


def _anc(model):
    anc = np.asarray(model.anc_dof_body).astype(bool)
    anc_p = anc[:, np.asarray(model.cp_body)].T
    return anc, anc_p


@pytest.mark.parametrize("which", ["reset", "stance"])
def test_cache_core_matches_jax(world, which):
    model, ph, em, *_ = world[which]
    anc, anc_p = _anc(model)
    r = em.p_cp_t - jnp.asarray(ph["base_pos"]).T[None]
    Jj, Wj = j_pc.cache_core(jnp.asarray(anc_p, jnp.float32), em.Sw_t,
                             em.Sv_t, em.Minv_t, r, eps=1e-6)
    Jt, Wt = t_pc.cache_core(t(anc_p.astype(np.float32)), t(em.Sw_t),
                             t(em.Sv_t), t(em.Minv_t), t(r), eps=1e-6)
    assert_close(Jt, Jj, RTOL, ATOL)
    assert_close(Wt, Wj, RTOL, ATOL)


@pytest.mark.parametrize("which", ["reset", "stance"])
def test_dyn_core_matches_jax(world, which):
    model, ph, em, rh_t, mu_t, e_t, g_t = world[which]
    anc, _ = _anc(model)
    rs = np.random.RandomState(7)
    tau = rs.uniform(-5, 5, (18, N)).astype(np.float32)
    tau[:6] = 0.0
    gv = rs.uniform(-1, 1, (18, N)).astype(np.float32)
    kw = dict(anc=anc, joint_body=np.asarray(model.joint_body),
              nb=model.nb, nj=model.nj, nv=model.nv)
    qj = j_pd.dyn_core(em.Sw_t, em.Sv_t, em.A_t, em.B_t, em.m_t, em.Minv_t,
                       g_t, jnp.asarray(tau), jnp.asarray(gv), **kw)
    qt = t_pd.dyn_core(t(em.Sw_t), t(em.Sv_t), t(em.A_t), t(em.B_t),
                       t(em.m_t), t(em.Minv_t), t(g_t), t(tau), t(gv), **kw)
    # accelerations reach 1e3: the absolute floor scales with them
    assert_close(qt, qj, RTOL, 1e-4)


@pytest.mark.parametrize("which,warm", [("reset", False), ("stance", False),
                                        ("stance", True)])
def test_contact_core_matches_jax(world, which, warm):
    model, ph, em, rh_t, mu_t, e_t, g_t = world[which]
    anc, anc_p = _anc(model)
    groups = tuple(j_pc.point_dof_groups(anc_p))
    assert groups == tuple(t_pc.point_dof_groups(anc_p))
    r = em.p_cp_t - jnp.asarray(ph["base_pos"]).T[None]
    Jj, Wj = j_pc.cache_core(jnp.asarray(anc_p, jnp.float32), em.Sw_t,
                             em.Sv_t, em.Minv_t, r, eps=1e-6)
    rs = np.random.RandomState(11)
    gv = rs.uniform(-1, 1, (18, N)).astype(np.float32)
    gv[5] -= 1.0      # falling: contacts engage
    lam0 = np.abs(rs.uniform(0, 0.05, (28, 3, N))).astype(np.float32)
    vlim = np.concatenate([np.full(3, 25.0), np.full(3, 15.0),
                           np.asarray(model.dof_vel_limit)]
                          ).astype(np.float32)[:, None]
    kw = dict(num_iters=3 if warm else 16, groups=groups, **STATICS)
    gj, pj, lj = j_pc.contact_core(
        Jj, Wj, em.Minv_t, em.p_cp_t, jnp.asarray(gv), rh_t, mu_t, e_t,
        jnp.asarray(vlim), lam0=jnp.asarray(lam0) if warm else None, **kw)
    gt, pt, lt = t_pc.contact_core(
        t(Jj), t(Wj), t(em.Minv_t), t(em.p_cp_t), t(gv), t(rh_t), t(mu_t),
        t(e_t), t(vlim), lam0=t(lam0) if warm else None, **kw)
    if which == "stance":
        assert float(np.abs(np.asarray(lj)).max()) > 1e-3   # contacts active
    # 16 chained sweeps amplify rounding: one decade above the single-call
    # tolerance
    assert_close(gt, gj, 1e-4, 1e-5)
    assert_close(pt, pj, 1e-4, 1e-5)
    assert_close(lt, lj, 1e-4, 1e-5)


def _control_step_both(world, which):
    model, ph, em, rh_t, mu_t, e_t, g_t = world[which]
    tmodel = t_go1()
    anc, anc_p = _anc(model)
    groups = tuple(j_pc.point_dof_groups(anc_p))
    rs = np.random.RandomState(23)
    D = 4
    default = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                        0.1, 1.0, -1.5, -0.1, 1.0, -1.5], np.float32)
    tgt = (default[None, :, None]
           + 0.1 * rs.randn(D, 12, N)).astype(np.float32)
    strengths = rs.uniform(0.9, 1.1, (12, N)).astype(np.float32)
    hist = [0.05 * rs.randn(12, N).astype(np.float32) for _ in range(4)]
    lam_in = np.zeros((28, 3, N), np.float32)
    if which == "stance":
        lam_in[:, 2] = np.abs(rs.uniform(0, 0.1, (28, N)))
    vlim = np.concatenate([np.full(3, 25.0), np.full(3, 15.0),
                           np.asarray(model.dof_vel_limit)]
                          ).astype(np.float32)[:, None]
    tlim = np.asarray(model.dof_effort, np.float32)[:, None]
    qlo = np.asarray(model.dof_lower, np.float32)[:, None]
    qhi = np.asarray(model.dof_upper, np.float32)[:, None]
    state_t = [ph[k].T.copy() for k in ("q", "qd", "base_pos", "base_quat",
                                        "base_lin_vel", "base_ang_vel")]

    # JAX: the kernel body, eagerly
    wj = j_pm.blockdiag_actuator_weights(j_act.load())
    j_inputs = ([jnp.asarray(anc_p, jnp.float32), em.Sw_t, em.Sv_t, em.A_t,
                 em.B_t, em.m_t, em.Minv_t, em.p_cp_t, rh_t, mu_t, e_t, g_t,
                 jnp.asarray(lam_in)]
                + [jnp.asarray(x) for x in state_t]
                + [jnp.asarray(tgt), jnp.asarray(strengths)] + list(wj)
                + [jnp.asarray(h) for h in hist]
                + [jnp.asarray(x) for x in (vlim, tlim, qlo, qhi)])
    boxes = [_Box() for _ in OUT_NAMES]
    common = dict(num_iters=16, warm_iters=3, contact=True,
                  limit_stiffness=60.0, limit_damping=2.0,
                  max_base_ang_vel=25.0, max_base_lin_vel=15.0, **STATICS)
    j_pm._megastep_kernel(
        *j_inputs, *boxes, anc=anc, joint_body=np.asarray(model.joint_body),
        groups=groups, nb=model.nb, nj=model.nj, nv=model.nv, P=28, D=D,
        warm0=True, flat=True, control_type="actuator_net", eps=1e-6,
        **common)
    j_out = [np.asarray(b.value) for b in boxes]

    # port: the wrapper on CPU tensors (= the plain version)
    t_em = EnvMinorCache(Sw_t=t(em.Sw_t), Sv_t=t(em.Sv_t), Minv_t=t(em.Minv_t),
                         A_t=t(em.A_t), B_t=t(em.B_t), m_t=t(em.m_t),
                         r_t=t(em.r_t), p_cp_t=t(em.p_cp_t))
    wt = t_pm.blockdiag_actuator_weights(t_act.load(device="cpu"),
                                         device="cpu")
    for a, b in zip(wt, wj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    before = t_pm.launches
    t_out = t_pm.control_step(
        t_em, t(rh_t), t(mu_t), t(e_t), t(g_t), None,
        *[t(x) for x in state_t], t(tgt), t(strengths),
        tuple(wt) + tuple(t(h) for h in hist),
        t(vlim), t(tlim), t(qlo), t(qhi), t(lam_in),
        model=tmodel, control_type="actuator_net", decimation=D, **common)
    assert t_pm.launches == before      # CPU tensors launch no kernel
    return j_out, t_out


@pytest.mark.parametrize("which", ["reset", "stance"])
def test_control_step_matches_jax_kernel_body(world, which):
    j_out, t_out = _control_step_both(world, which)
    assert len(t_out) == len(OUT_NAMES)
    if which == "stance":
        assert float(np.abs(j_out[8]).max()) > 1e-3       # feet load the ground
    for name, a, b in zip(OUT_NAMES, t_out, j_out):
        assert tuple(a.shape) == b.shape, name
        assert_close(a, b, RTOL, ATOL, err_msg=name)


def test_control_step_on_cuda_has_no_plain_path():
    """The wrapper's CUDA branch never reaches the plain version: it raises
    for what the kernel does not cover, and its source does not name
    control_step_reference after the CPU return."""
    import inspect
    src = inspect.getsource(t_pm.control_step)
    head, tail = src.split('if dev.type != "cuda"', 1)
    assert "control_step_reference" in head
    assert "control_step_reference" not in tail
    for banned in ("torch.matmul", "F.linear", "torch.compile", " @ "):
        assert banned not in tail
