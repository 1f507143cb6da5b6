"""Plain PyTorch control-step cores vs the JAX functions, on the CPU.

`cache_core`, `dyn_core` and `contact_core` of the JAX package are plain jnp
functions: they are called directly.  The whole control step is held against
the JAX kernel BODY run eagerly: `_megastep_kernel` is called with jnp arrays
as its input "refs" (`x[:]` works on an array) and a small box class as each
output ref — no `pallas_call`, no interpret mode.

Tolerance: rtol 1e-5 / atol 1e-6 for one call — both sides are float32 and do
the same operations in the same order; only the order inside sums and matrix
products differs.

Heightfield cases (surface normals: the general-normal rows of
`contact_core`, K4b's arithmetic) put the same seeded states on an inclined,
bumpy field (`_rough_inputs`), so that the normals are far from +z.
"""
import os

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
from walk_these_ways_tpu_torch.ops import _build
from walk_these_ways_tpu_torch.ops import contact as t_pc
from walk_these_ways_tpu_torch.ops import dynamics as t_pd
from walk_these_ways_tpu_torch.ops import megastep as t_pm
from walk_these_ways_tpu_torch.physics import engine as t_engine
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


def _jax_inputs(*seeds_heights, terrain=None):
    """Env-minor kernel inputs from the JAX package (block = the batch: no
    padding) for N envs per (seed, height), the groups side by side; on a
    JAX `terrain`, each base stands `height` above the ground under it, and
    the inputs end with the surface normals n_t."""
    model = j_go1()
    ph = [random_phys_np(N, sd, h) for sd, h in seeds_heights]
    dy = [random_dyn_np(N, sd) for sd, _ in seeds_heights]
    ph, dy = ({k: np.concatenate([d[k] for d in ds]) for k in ds[0]}
              for ds in (ph, dy))
    if terrain is not None:
        ground, _ = terrain.lookup(jnp.asarray(ph["base_pos"][:, 0]),
                                   jnp.asarray(ph["base_pos"][:, 1]))
        ph["base_pos"][:, 2] += np.asarray(ground)
    state = j_engine.PhysicsState(**{k: jnp.asarray(v) for k, v in ph.items()})
    dyn = j_engine.DynamicsParams(**{k: jnp.asarray(v) for k, v in dy.items()})
    em, rh_t, mu_t, e_t, g_t, n_t = j_engine.build_pallas_env_inputs(
        model, state, dyn, terrain, block=N * len(seeds_heights))
    assert (n_t is None) == (terrain is None)
    out = (model, ph, em, rh_t, mu_t, e_t, g_t, dy)
    return out if terrain is None else out + (n_t,)


def _slope_heights():
    """An inclined (about 14 deg), bumpy 4 m x 4 m field, 0.1 m pitch,
    origin (-2, -2): it covers every contact point of STATES."""
    rs = np.random.RandomState(3)
    gx, gy = np.meshgrid(np.arange(41) * 0.1 - 2.0, np.arange(41) * 0.1 - 2.0,
                         indexing="ij")
    return (0.25 * gx - 0.1 * gy + 0.02 * rs.randn(41, 41)).astype(np.float32)


def _rough_inputs():
    """Both states of STATES side by side on the slope of
    `_slope_heights`."""
    terrain = j_engine.make_heightfield_terrain(_slope_heights(), 0.1,
                                                (-2.0, -2.0))
    return _jax_inputs(*[(seed, hh) for _, seed, hh in STATES],
                       terrain=terrain)


STATES = (("reset", 0, 0.34), ("stance", 1, 0.27))


@pytest.fixture(scope="module")
def world():
    return {name: _jax_inputs((seed, height)) for name, seed, height in STATES}


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
    model, ph, em, rh_t, mu_t, e_t, g_t, _ = world[which]
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
    model, ph, em, rh_t, mu_t, e_t, g_t, _ = world[which]
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


@pytest.fixture(scope="module")
def rough():
    return _rough_inputs()


@pytest.mark.parametrize("warm", [False, True])
def test_contact_core_with_normals_matches_jax(rough, warm):
    """The general-normal rows (K4b's and K3b's arithmetic), cold with 16
    sweeps and warm-started with 3 from a seed that is not along +z."""
    model, ph, em, rh_t, mu_t, e_t, g_t, dy, n_t = rough
    n = ph["q"].shape[0]
    _, anc_p = _anc(model)
    groups = tuple(j_pc.point_dof_groups(anc_p))
    r = em.p_cp_t - jnp.asarray(ph["base_pos"]).T[None]
    Jj, Wj = j_pc.cache_core(jnp.asarray(anc_p, jnp.float32), em.Sw_t,
                             em.Sv_t, em.Minv_t, r, eps=1e-6)
    rs = np.random.RandomState(12)
    gv = rs.uniform(-1, 1, (18, n)).astype(np.float32)
    gv[5] -= 1.0      # falling: contacts engage
    lam0 = rs.uniform(-0.02, 0.02, (28, 3, n)).astype(np.float32)
    lam0[:, 2] += 0.04
    vlim = np.concatenate([np.full(3, 25.0), np.full(3, 15.0),
                           np.asarray(model.dof_vel_limit)]
                          ).astype(np.float32)[:, None]
    kw = dict(num_iters=3 if warm else 16, groups=groups, **STATICS)
    gj, pj, lj = j_pc.contact_core(
        Jj, Wj, em.Minv_t, em.p_cp_t, jnp.asarray(gv), rh_t, mu_t, e_t,
        jnp.asarray(vlim), n=n_t, lam0=jnp.asarray(lam0) if warm else None,
        **kw)
    gt, pt, lt = t_pc.contact_core(
        t(Jj), t(Wj), t(em.Minv_t), t(em.p_cp_t), t(gv), t(rh_t), t(mu_t),
        t(e_t), t(vlim), n=t(n_t), lam0=t(lam0) if warm else None, **kw)
    assert float(np.asarray(n_t)[:, 2].min()) < 0.95     # normals lean
    lj = np.asarray(lj)
    assert float(np.abs(lj).max()) > 1e-3                # contacts active
    # impulses off the vertical: the tangential rows are exercised
    assert float(np.abs(lj[:, :2]).max()) > 1e-3
    # 16 chained sweeps amplify rounding: one decade above the single-call
    # tolerance, as on flat ground
    assert_close(gt, gj, 1e-4, 1e-5)
    assert_close(pt, pj, 1e-4, 1e-5)
    assert_close(lt, lj, 1e-4, 1e-5)


def _eager_fori_loop(lower, upper, body, carry):
    for i in range(lower, upper):
        carry = body(jnp.int32(i), carry)
    return carry


def _control_step_both(inputs, control_type="actuator_net", exact=False,
                       seeded=(), entry=False):
    """One control step of the JAX kernel body (eagerly) and of the port's
    wrapper on CPU tensors (= the plain version), on the same inputs
    (`_jax_inputs`; with surface normals where they end in n_t); reuse
    mode seeds the impulses of the envs in `seeded` from a previous step.
    With `entry` the wrapper is given what K4 and K4b take on the card in
    place of the JAX package's eager build: the state, the payload, the
    COM shift, the point radii and (with normals) the port's heightfield
    of `_slope_heights`, and builds the cache and samples the field
    itself.
    Exact mode shapes the JAX inputs as engine.control_step_megakernel
    does: the batch split (8, n / 8), the mask (P, nv, 1, 1), bound columns
    (rows, 1, 1), no cross-step seed, no warm start."""
    model, ph, em, rh_t, mu_t, e_t, g_t, dy = inputs[:8]
    n_t = inputs[8] if len(inputs) > 8 else None
    n = ph["q"].shape[0]
    tmodel = t_go1()
    anc, anc_p = _anc(model)
    groups = tuple(j_pc.point_dof_groups(anc_p))
    rs = np.random.RandomState(23)
    D = 4
    default = np.array([0.1, 0.8, -1.5, -0.1, 0.8, -1.5,
                        0.1, 1.0, -1.5, -0.1, 1.0, -1.5], np.float32)
    tgt = (default[None, :, None]
           + 0.1 * rs.randn(D, 12, n)).astype(np.float32)
    strengths = rs.uniform(0.9, 1.1, (12, n)).astype(np.float32)
    hist = [0.05 * rs.randn(12, n).astype(np.float32) for _ in range(4)]
    kp = (20.0 * rs.uniform(0.9, 1.1, (12, n))).astype(np.float32)
    kd = (0.5 * rs.uniform(0.9, 1.1, (12, n))).astype(np.float32)
    lam_in = np.zeros((28, 3, n), np.float32)
    lam_in[:, 2, list(seeded)] = np.abs(rs.uniform(0, 0.1, (28, len(seeded))))
    vlim = np.concatenate([np.full(3, 25.0), np.full(3, 15.0),
                           np.asarray(model.dof_vel_limit)]
                          ).astype(np.float32)[:, None]
    tlim = np.asarray(model.dof_effort, np.float32)[:, None]
    qlo = np.asarray(model.dof_lower, np.float32)[:, None]
    qhi = np.asarray(model.dof_upper, np.float32)[:, None]
    state_t = [ph[k].T.copy() for k in ("q", "qd", "base_pos", "base_quat",
                                        "base_lin_vel", "base_ang_vel")]
    exact_in = (dy["payload"][None].copy(), dy["com_displacement"].T.copy())
    pctrl = control_type == "P"

    # JAX: the kernel body, eagerly
    def split(x):
        x = jnp.asarray(x)
        return x.reshape(x.shape[:-1] + (8, x.shape[-1] // 8)) if exact else x

    wj = j_pm.blockdiag_actuator_weights(j_act.load())
    batch = ([rh_t, mu_t, e_t, g_t] + ([] if n_t is None else [n_t])
             + ([] if exact else [lam_in])
             + state_t + [tgt, strengths]
             + ([kp, kd] if pctrl else []))
    bounds = [jnp.asarray(x)[..., None] if exact else jnp.asarray(x)
              for x in (vlim, tlim, qlo, qhi)]
    if exact:
        head = [jnp.asarray(anc_p, jnp.float32)[:, :, None, None]] + [
            split(x) for x in exact_in]
    else:
        head = [jnp.asarray(anc_p, jnp.float32), em.Sw_t, em.Sv_t, em.A_t,
                em.B_t, em.m_t, em.Minv_t, em.p_cp_t]
    j_inputs = head + [split(x) for x in batch]
    if not pctrl:
        j_inputs += list(wj) + [split(h) for h in hist]
    j_inputs += bounds
    names = OUT_NAMES[:10] if pctrl else OUT_NAMES
    boxes = [_Box() for _ in names]
    common = dict(num_iters=16, warm_iters=0 if exact else 3, contact=True,
                  limit_stiffness=60.0, limit_damping=2.0,
                  max_base_ang_vel=25.0, max_base_lin_vel=15.0, **STATICS)
    with pytest.MonkeyPatch.context() as mp:
        # exact mode loops over the substeps with lax.fori_loop, which
        # compiles its body (a minute of XLA on the CPU); the same body run
        # eagerly, substep index as a traced-like int32, is the same
        # arithmetic
        mp.setattr(j_pm.jax.lax, "fori_loop", _eager_fori_loop)
        j_pm._megastep_kernel(
            *j_inputs, *boxes, anc=anc,
            joint_body=np.asarray(model.joint_body), groups=groups,
            nb=model.nb, nj=model.nj, nv=model.nv, P=28, D=D,
            warm0=not exact, flat=n_t is None, control_type=control_type,
            eps=1e-6,
            exact=exact, model=model if exact else None, **common)
    j_out = [np.asarray(b.value) for b in boxes]
    if exact:
        j_out = [x.reshape(x.shape[:-2] + (n,)) for x in j_out]

    # port: the wrapper on CPU tensors (= the plain version)
    t_rh, t_n, entry_inputs = t(rh_t), None if n_t is None else t(n_t), None
    if entry:
        terrain = None if n_t is None else t_engine.make_heightfield_terrain(
            _slope_heights(), 0.1, (-2.0, -2.0), device="cpu")
        entry_inputs = (t(exact_in[0]), t(exact_in[1]), terrain)
        radius = np.asarray(model.cp_radius, np.float32)[:, None]
        t_rh, t_n = t(np.repeat(radius, n, axis=1)), None
    t_em = None if exact or entry else EnvMinorCache(
        Sw_t=t(em.Sw_t), Sv_t=t(em.Sv_t), Minv_t=t(em.Minv_t),
        A_t=t(em.A_t), B_t=t(em.B_t), m_t=t(em.m_t), r_t=t(em.r_t),
        p_cp_t=t(em.p_cp_t))
    wt = t_pm.blockdiag_actuator_weights(t_act.load(device="cpu"),
                                         device="cpu")
    for a, b in zip(wt, wj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ctrl = ((t(kp), t(kd)) if pctrl
            else tuple(wt) + tuple(t(h) for h in hist))
    counters = ("launches", "p_launches", "normal_launches",
                "p_normal_launches", "exact_launches")
    before = [getattr(t_pm, c) for c in counters]
    t_out = t_pm.control_step(
        t_em, t_rh, t(mu_t), t(e_t), t(g_t), t_n,
        *[t(x) for x in state_t], t(tgt), t(strengths), ctrl,
        t(vlim), t(tlim), t(qlo), t(qhi), None if exact else t(lam_in),
        model=tmodel, control_type=control_type, decimation=D,
        exact_inputs=tuple(t(x) for x in exact_in) if exact else None,
        entry_inputs=entry_inputs, **common)
    # CPU tensors launch no kernel
    assert [getattr(t_pm, c) for c in counters] == before
    return j_out, t_out


@pytest.mark.parametrize("which", ["reset", "stance"])
def test_control_step_matches_jax_kernel_body(world, which):
    j_out, t_out = _control_step_both(
        world[which], seeded=range(N) if which == "stance" else ())
    assert len(t_out) == len(OUT_NAMES)
    if which == "stance":
        assert float(np.abs(j_out[8]).max()) > 1e-3       # feet load the ground
    for name, a, b in zip(OUT_NAMES, t_out, j_out):
        assert tuple(a.shape) == b.shape, name
        assert_close(a, b, RTOL, ATOL, err_msg=name)


VARIANTS = {"P_reuse": ("P", False), "P_exact": ("P", True),
            "actuator_net_exact": ("actuator_net", True)}
# Exact mode rebuilds M and its closed-form inverse (M^-1 entries up to 1e2)
# before each of four cold 16-sweep solves; the joint velocities (up to
# 28 rad/s), the histories that hold them and the torques made from them
# take the float32 differences of the two sides' summation orders beyond
# rtol 1e-5: measured at most 2.6e-6 (vll) with the JAX body run eagerly,
# 6.9e-6 (tau) with its substep loop compiled.
ATOL_EXACT = 2e-5
# P control multiplies a joint angle's rounding by kp = 20: the last
# substep's torque, measured 1.8e-6 beyond rtol 1e-5 (reuse mode, stance).
ATOL_TAU_P = 1e-5


@pytest.fixture(scope="module")
def variants():
    """Each variant once on both states side by side (reset | stance): the
    JAX body's cost is per call, not per env."""
    inputs = _jax_inputs(*[(seed, h) for _, seed, h in STATES])
    return {name: _control_step_both(inputs, ct, ex,
                                     seeded=range(N, 2 * N))
            for name, (ct, ex) in VARIANTS.items()}


@pytest.mark.parametrize("which", ["reset", "stance"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_control_step_variants_match_jax_kernel_body(variants, which,
                                                     variant):
    """K4c (P control, reuse) and K5 (exact mode, both torque models): the
    plain versions against the JAX kernel body."""
    control_type, exact = VARIANTS[variant]
    j_out, t_out = variants[variant]
    envs = slice(0, N) if which == "reset" else slice(N, 2 * N)
    assert len(t_out) == (10 if control_type == "P" else 14)
    if which == "stance":
        # feet load the ground
        assert float(np.abs(j_out[8][..., envs]).max()) > 1e-3
    for name, a, b in zip(OUT_NAMES, t_out, j_out):
        assert tuple(a.shape) == b.shape, name
        atol = ATOL_EXACT if exact else (
            ATOL_TAU_P if name == "tau" and control_type == "P" else ATOL)
        assert_close(a[..., envs], b[..., envs], RTOL, atol, err_msg=name)


# On the slope the impulses reach 0.49 (0.32 tangential) and the general-
# normal rows renormalise a 3-D slip in each of 3 sweeps per substep; the
# summation-order rounding that reaches the joint velocities goes through
# the actuator network into the torques and is carried by the velocity
# histories.  Measured beyond rtol 1e-5 with the actuator network (x86-64,
# one thread): tau 5.1e-6, vl 1.4e-6, vll 9.0e-7, qd 8.4e-7; every other
# output, and every output with P control, within the flat-ground atol.
ATOL_NORMALS_NET = 1e-5


@pytest.fixture(scope="module")
def normal_variants(rough):
    """K4b's plain version with either torque model against the JAX kernel
    body with flat=False, both states side by side (the stance group
    seeded from a previous step)."""
    return {ct: _control_step_both(rough, ct, seeded=range(N, 2 * N))
            for ct in ("actuator_net", "P")}


@pytest.mark.parametrize("which", ["reset", "stance"])
@pytest.mark.parametrize("control_type", ["actuator_net", "P"])
def test_control_step_with_normals_matches_jax_kernel_body(
        normal_variants, control_type, which):
    j_out, t_out = normal_variants[control_type]
    envs = slice(0, N) if which == "reset" else slice(N, 2 * N)
    assert len(t_out) == (10 if control_type == "P" else 14)
    if which == "stance":
        # feet load the slope
        assert float(np.abs(j_out[8][..., envs]).max()) > 1e-3
    for name, a, b in zip(OUT_NAMES, t_out, j_out):
        assert tuple(a.shape) == b.shape, name
        if control_type == "P":
            atol = ATOL_TAU_P if name == "tau" else ATOL
        else:
            atol = (ATOL_NORMALS_NET if name in ("qd", "tau", "vl", "vll")
                    else ATOL)
        assert_close(a[..., envs], b[..., envs], RTOL, atol, err_msg=name)


# The entry form builds the cache from the state on the port's side
# (torch's sin / cos against XLA's in the JAX package's eager build): one
# more rounding in M^-1 and the contact points, carried into the joint
# velocities, the torques made from them and the velocity histories.
# Measured beyond rtol 1e-5 (x86-64, one thread): flat qd 1.5e-6, tau
# 1.0e-6, vl 1.4e-6, vll 7.5e-7; slope tau 2.5e-6, qd 1.5e-6, vl 1.2e-6;
# with P control flat qd 6.1e-7, tau 6.3e-7, slope qd 1.3e-6, tau 6.8e-7;
# every other output within the flat-ground atol.
ATOL_ENTRY = 1e-5


@pytest.fixture(scope="module")
def entry_variants(rough):
    """The wrapper's entry form (what the team kernel takes on the card:
    state, payload, COM shift and the heightfield in; the cache built and
    the field sampled inside) against the JAX kernel body fed the JAX
    package's eager build: flat ground and the slope, with the actuator
    network (K4, K4b) and with P control (K4c, K4b-P, keys ending in
    "_P"), both states side by side."""
    flat = _jax_inputs(*[(seed, h) for _, seed, h in STATES])
    return {ground + suffix: _control_step_both(
                inputs, control_type, seeded=range(N, 2 * N), entry=True)
            for ground, inputs in (("flat", flat), ("rough", rough))
            for suffix, control_type in (("", "actuator_net"), ("_P", "P"))}


@pytest.mark.parametrize("which", ["reset", "stance"])
@pytest.mark.parametrize("ground", ["flat", "rough", "flat_P", "rough_P"])
def test_control_step_entry_inputs_match_jax_kernel_body(entry_variants,
                                                         ground, which):
    """The team kernel's arithmetic as the card runs it, from the entry
    state (K4, K4b; K4c, K4b-P with P control): within the tolerances of
    the flat-ground and the normals cases."""
    j_out, t_out = entry_variants[ground]
    envs = slice(0, N) if which == "reset" else slice(N, 2 * N)
    assert len(t_out) == (10 if ground.endswith("_P") else len(OUT_NAMES))
    if which == "stance":
        assert float(np.abs(j_out[8][..., envs]).max()) > 1e-3
    for name, a, b in zip(OUT_NAMES, t_out, j_out):
        assert tuple(a.shape) == b.shape, name
        atol = ATOL_ENTRY if name in ("qd", "tau", "vl", "vll") else ATOL
        assert_close(a[..., envs], b[..., envs], RTOL, atol, err_msg=name)


def test_entry_inputs_cache_matches_the_eager_build():
    """`entry_cache_reference` (the plain form of K4's and K4b's in-launch
    build) against physics/engine.build_pallas_env_inputs from the same
    state on the port's slope: the same cache, heights and normals on the
    valid lanes; the padded lanes' normals are unit vectors."""
    tmodel = t_go1()
    n, block = 12, 16
    ph, dy = random_phys_np(n, 1, 0.3), random_dyn_np(n, 1)
    terrain = t_engine.make_heightfield_terrain(_slope_heights(), 0.1,
                                                (-2.0, -2.0), device="cpu")
    ground, _ = terrain.lookup(t(ph["base_pos"][:, 0]),
                               t(ph["base_pos"][:, 1]))
    ph["base_pos"][:, 2] += ground.numpy()
    state = t_engine.PhysicsState(**{k: t(v) for k, v in ph.items()})
    dyn = t_engine.DynamicsParams(**{k: t(v) for k, v in dy.items()})
    em, rh_t, _, _, _, n_t = t_engine.build_pallas_env_inputs(
        tmodel, state, dyn, terrain, block)
    radius = torch.tensor(np.asarray(tmodel.cp_radius, np.float32))
    em2, rh2, n2 = t_pm.entry_cache_reference(
        tmodel, t_pc.to_env_minor(state.q, block),
        t_pc.to_env_minor(state.base_quat, block),
        t_pc.to_env_minor(state.base_pos, block),
        radius[:, None].expand(28, block).contiguous(),
        (t_pc.to_env_minor(dyn.payload[:, None], block),
         t_pc.to_env_minor(dyn.com_displacement, block), terrain))
    for a, b in list(zip(em2, em)) + [(rh2, rh_t), (n2, n_t)]:
        assert tuple(a.shape) == tuple(b.shape)
        assert_close(a[..., :n], b[..., :n].numpy(), 1e-6, 1e-6)
    assert float(n_t[:, 2, :n].min()) < 0.99                # the slope
    norm = (n2 * n2).sum(dim=1).sqrt()
    assert_close(norm, np.ones((28, block), np.float32), 1e-6, 1e-6)


def test_control_step_on_cuda_has_no_plain_path():
    """The wrapper's CUDA branch never reaches the plain version, for any
    variant (K4, K4b, K4c with P control and K4b-P in reuse mode, K5 and
    K5-P in exact mode, all in the team kernel): it launches the kernel or
    raises for what the kernel does not cover; its source does not name
    control_step_reference, the eager entry-cache build, the exact-mode
    cache rebuild, a library product or the removed one-thread kernel
    after the CPU return, and a tensor on neither the CPU nor a CUDA device
    raises.  Exact mode with normals raises on every device.  The operand
    packing, which runs before any launch, refuses a host-built cache or
    normals (the kernel builds them in the launch) and a call that is
    neither reuse mode with entry_inputs nor exact mode; the team
    kernel's launcher takes exact mode on flat ground without a seed
    only."""
    import inspect
    src = inspect.getsource(t_pm.control_step)
    head, tail = src.split('if dev.type != "cuda"', 1)
    assert "control_step_reference" in head
    banned_names = ("control_step_reference", "entry_cache_reference",
                    "_cache_arrays", "envminor", "cache_columns", "lookup",
                    "torch.matmul", "F.linear", "torch.compile", " @ ",
                    "csrc/megastep.cu", '"megastep"', "megastep_launch",
                    "KERNEL_THREADS")
    for banned in banned_names:
        assert banned not in tail, banned
    # the variants each pass their own flags to the team kernel's launch,
    # packed by kernel_operands, which names no plain path either: reuse
    # mode (the entry form) and exact mode, either torque model
    assert "kernel_operands(" in tail
    assert tail.index("kernel_operands(") < tail.index("_build.launch(")
    assert "exact_inputs is not None and n_t is not None" in tail
    assert '_build.launch(lib, "megastep_team", ' in tail
    assert "build_library(model, H, F)" in tail
    packing = inspect.getsource(t_pm.kernel_operands)
    assert ("ints = (Npad, D, num_iters, warm_iters, bool(contact), "
            "TEAM_THREADS,\n"
            "            pctrl, exact, terrain is None, c_rows, c_cols)"
            ) in packing
    assert '"n_t"' not in packing and "em." not in packing
    assert 'given["corners"] = (terrain.corners, (c_rows, c_cols, 4))' \
        in packing
    for banned in banned_names:
        assert banned not in packing, banned
    for counter in ("exact_launches += 1", "p_exact_launches += 1",
                    "p_launches += 1", "normal_launches += 1",
                    "p_normal_launches += 1", "launches += 1"):
        assert counter in tail
    m = t_go1()
    meta = torch.zeros(12, 8, device="meta")
    kw = dict(model=m, dt=0.005, num_iters=16, relaxation=0.4,
              baumgarte=0.2, slop=0.002, max_depen=1.0, bounce_thresh=0.5,
              contact=True, limit_stiffness=60.0, limit_damping=2.0,
              max_base_ang_vel=25.0, max_base_lin_vel=15.0, decimation=4)
    for ctrl, exact, n_t in (("P", False, None), ("P", True, None),
                             ("actuator_net", True, None),
                             ("actuator_net", False, meta),
                             ("P", False, meta)):
        with pytest.raises(ValueError, match="unsupported device"):
            t_pm.control_step(
                None, *[None] * 4, n_t, meta, meta, meta, meta, meta, meta,
                meta, meta, (meta, meta), None, None, None, None,
                control_type=ctrl,
                exact_inputs=(meta, meta) if exact else None, **kw)
    cpu = torch.zeros(12, 8)
    with pytest.raises(ValueError, match="flat-ground only"):
        t_pm.control_step(
            None, *[None] * 4, cpu, cpu, cpu, cpu, cpu, cpu, cpu, cpu, cpu,
            (cpu, cpu), None, None, None, None, control_type="P",
            exact_inputs=(cpu, cpu), **kw)
    # the packing: a host-built cache or normals in reuse mode, either
    # torque model, and a call with neither entry_inputs nor exact_inputs
    em = EnvMinorCache(*[cpu] * 8)
    entry = (cpu, cpu, None)
    for ctrl in ("P", "actuator_net"):
        for given_em, n_t, entry_in, match in (
                (em, None, entry, "em and n_t must be None"),
                (None, cpu, entry, "em and n_t must be None"),
                (em, None, None, "entry_inputs"),
                (None, None, None, "entry_inputs")):
            with pytest.raises(ValueError, match=match):
                t_pm.kernel_operands(
                    given_em, *[None] * 4, n_t, cpu, cpu, cpu, cpu, cpu,
                    cpu, cpu, cpu, (cpu, cpu), None, None, None, None,
                    control_type=ctrl, entry_inputs=entry_in, **kw)
    assert not os.path.exists(os.path.join(_build.CSRC_DIR, "megastep.cu"))
    with open(os.path.join(_build.CSRC_DIR, "megastep_team.cu")) as fh:
        team = fh.read()
    launcher = team[team.index('extern "C" int megastep_team_launch'):
                    team.index('extern "C" const char* megastep_team_error')]
    assert "(exact && (!flat || a.in[I_LAM] != nullptr))" in launcher
    assert launcher.count("megastep_team_kernel<") == 6
    assert launcher.count("megastep_team_kernel<true, true, true>") == 1
    assert launcher.count("megastep_team_kernel<true, false, true>") == 1
