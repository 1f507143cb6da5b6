"""Tests of the port that need an NVIDIA GPU (marker `gpu`).

They build the kernels with nvcc and launch them, so they skip on a machine
without a CUDA device.  Run them on the card with
    python -m pytest tests/test_torch_gpu.py -m gpu -p no:cacheprovider
"""
import numpy as np
import pytest
import torch

import dataclasses

from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv, make_generator
from walk_these_ways_tpu_torch.go1_config import (mob_train_cfg,
                                                  rough_train_cfg,
                                                  small_train_cfg)
from walk_these_ways_tpu_torch.ops import (contact, dynamics, entry_cache,
                                           megastep)
from walk_these_ways_tpu_torch.physics import engine, envminor

from process_group import run_group

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda", 0)


def _call(env, state, eager_cache=False):
    """(args, kwargs) of the control-step call of `env.step`; with
    `eager_cache` the entry cache built on the host, as the plain version of
    the team kernel's variants (K4, K4b, K4c, K4b-P) is fed (the kernel
    builds it in its launch)."""
    _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
    return engine.megakernel_args(
        env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
        state.motor_strengths, env.torque_limits, ctrl,
        env.cfg.control.decimation, lam_in, exact=not env.reuse_matrices,
        eager_cache=eager_cache)


def test_kernel_matches_plain_version_on_the_card(cuda):
    """K4 (the team kernel, entry cache built in its launch) against its
    plain version fed the eager build: |kernel - plain| <= 2e-4 + 2e-4
    |plain| on every output (float32; another summation order in the
    kernel)."""
    n = 256
    env = LeggedRobotEnv(mob_train_cfg(n), device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    for _ in range(10):
        state, *_ = env.step(state, torch.randn((n, 12), generator=gen,
                                                device=cuda))
    args, kwargs = _call(env, state)
    p_args, p_kwargs = _call(env, state, eager_cache=True)
    assert args[0] is None and kwargs["entry_inputs"] is not None
    assert args[-1] is not None and float(args[-1].abs().max()) > 0
    # with the cross-step seed (the main path), and without it: the first
    # substep then cold-starts at the full iteration count
    for seed in (args[-1], None):
        before = megastep.launches
        out_k = megastep.control_step(*args[:-1], seed, **kwargs)
        torch.cuda.synchronize()
        assert megastep.launches == before + 1
        out_r = megastep.control_step_reference(*p_args[:-1], seed,
                                                **p_kwargs)
        for a, b in zip(out_k, out_r):
            a, b = a[..., :n].cpu().numpy(), b[..., :n].cpu().numpy()
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


def test_wrapper_raises_for_what_the_kernel_does_not_cover(cuda):
    n = 128
    env = LeggedRobotEnv(mob_train_cfg(n), device=cuda)
    state, _ = env.reset(make_generator(0, cuda))
    args, kwargs = _call(env, state)
    normals = torch.zeros((28, 3, args[6].shape[-1]), device=cuda)
    normals[:, 2] = 1.0
    with pytest.raises(ValueError):                  # normals of 64 envs
        megastep.control_step(*args[:5], normals[..., :64], *args[6:],
                              **kwargs)
    with pytest.raises(ValueError):
        megastep.control_step(*args, **dict(kwargs, control_type="PD"))
    with pytest.raises(ValueError):
        megastep.control_step(*args[:6], args[6][:, :64], *args[7:], **kwargs)
    # exact mode (K5 in the team kernel) starts every solve cold: a
    # cross-step seed is refused; it is flat-ground only: normals are
    # refused; neither reaches a launch
    exact_kw = dict(kwargs, entry_inputs=None, exact_inputs=(
        torch.zeros((1, args[6].shape[-1]), device=cuda),
        torch.zeros((3, args[6].shape[-1]), device=cuda)))
    before = (megastep.exact_launches, megastep.p_exact_launches)
    with pytest.raises(ValueError, match="lam_in_t must be None"):
        megastep.control_step(None, *args[1:19], args[6][:, :1].new_zeros(
            (28, 3, args[6].shape[-1])), **exact_kw)
    with pytest.raises(ValueError, match="flat-ground only"):
        megastep.control_step(None, *args[1:5], normals, *args[6:19], None,
                              **exact_kw)
    assert (megastep.exact_launches, megastep.p_exact_launches) == before
    # reuse mode builds its cache in the launch, with either torque model:
    # a host-built cache is refused, and nothing is launched
    env_p = LeggedRobotEnv(small_train_cfg(n), device=cuda)
    state_p, _ = env_p.reset(make_generator(0, cuda))
    for e, st in ((env, state), (env_p, state_p)):
        p_args, p_kwargs = _call(e, st, eager_cache=True)
        assert p_args[0] is not None and p_kwargs["entry_inputs"] is None
        before = (megastep.launches, megastep.p_launches)
        with pytest.raises(ValueError, match="em and n_t must be None"):
            megastep.control_step(*p_args, **dict(
                p_kwargs, entry_inputs=_call(e, st)[1]["entry_inputs"]))
        with pytest.raises(ValueError, match="entry_inputs"):
            megastep.control_step(*p_args, **p_kwargs)
        assert (megastep.launches, megastep.p_launches) == before


@pytest.mark.parametrize("control_type", ["actuator_net", "P"])
def test_normals_kernel_matches_plain_version_on_the_card(cuda,
                                                          control_type):
    """K4b and K4b-P (the team kernel: entry cache and heightfield
    samples in its launch) on rough_train_cfg, 10 random steps in, against
    the plain version fed the eager build: |kernel - plain| <= 2e-4 + 2e-4
    |plain|; every lane finite, padded ones included."""
    n = 250                          # 6 padded lanes
    cfg = rough_train_cfg(n)
    cfg = dataclasses.replace(cfg, control=dataclasses.replace(
        cfg.control, control_type=control_type))
    env = LeggedRobotEnv(cfg, device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    for _ in range(10):
        state, *_ = env.step(state, torch.randn((n, 12), generator=gen,
                                                device=cuda))
    args, kwargs = _call(env, state)
    p_args, p_kwargs = _call(env, state, eager_cache=True)
    assert p_args[5] is not None                 # the normals
    assert args[5] is None and kwargs["entry_inputs"][2] is not None
    counters = ("launches", "p_launches", "normal_launches",
                "p_normal_launches")
    before = [getattr(megastep, c) for c in counters]
    out_k = megastep.control_step(*args, **kwargs)
    torch.cuda.synchronize()
    assert [getattr(megastep, c) - b for c, b in zip(counters, before)] == (
        [0, 0, 1, 0] if control_type == "actuator_net" else [0, 0, 0, 1])
    out_r = megastep.control_step_reference(*p_args, **p_kwargs)
    for a, b in zip(out_k, out_r):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a[..., :n].cpu().numpy(),
                                   b[..., :n].cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route", ["flat", "rough", "rough_exact", "p",
                                   "rough_p", "flat_exact", "p_exact"])
def test_team_kernel_routes_make_no_eager_cache_build_on_the_card(cuda,
                                                                  route):
    """The default route (K4), the rough default route (K4b), the rough
    exact route (`decimation` K4b launches of one substep), the P-control
    route (K4c, small_train_cfg) and the rough P-control route (K4b-P)
    build their entry cache in the launch, the flat exact routes (K5, K5-P
    with small_train_cfg) their cache before every substep: no eager
    build; every output finite."""
    n = 256
    cfg = {"flat": mob_train_cfg, "flat_exact": mob_train_cfg,
           "p": small_train_cfg, "p_exact": small_train_cfg}.get(
        route, rough_train_cfg)(n)
    if route.endswith("exact"):
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, reuse_matrices=False))
    if route == "rough_p":
        cfg = dataclasses.replace(cfg, control=dataclasses.replace(
            cfg.control, control_type="P"))
    env = LeggedRobotEnv(cfg, device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    counter = {"flat": "launches", "p": "p_launches",
               "rough_p": "p_normal_launches",
               "flat_exact": "exact_launches",
               "p_exact": "p_exact_launches"}.get(route, "normal_launches")
    builds, before = envminor.cache_builds, getattr(megastep, counter)
    for _ in range(3):
        state, obs, rew, *_ = env.step(state, torch.randn(
            (n, 12), generator=gen, device=cuda))
    torch.cuda.synchronize()
    assert envminor.cache_builds == builds
    per_step = env.cfg.control.decimation if route == "rough_exact" else 1
    assert getattr(megastep, counter) == before + 3 * per_step
    assert bool(torch.isfinite(obs["obs"]).all())
    assert bool(torch.isfinite(state.phys.base_pos).all())


@pytest.mark.parametrize("route", ["flat", "rough", "flat_exact",
                                   "rough_exact"])
def test_substep_routes_make_no_eager_cache_build_on_the_card(cuda, route):
    """The per-substep routes (`sim.megastep=False`), reuse and exact mode,
    flat and rough: the entry-cache kernel builds the cache, no eager
    build.  Per control step reuse mode launches the entry cache and K1
    once and K3 (K3b) `decimation` times, exact mode `decimation` times
    each; every output finite.  The entry-cache kernel matches the eager
    build on every lane: |kernel - plain| <= 2e-4 + 2e-4 |plain|."""
    n = 250                          # 6 padded lanes
    rough = route.startswith("rough")
    exact = route.endswith("exact")
    cfg = (rough_train_cfg if rough else mob_train_cfg)(n)
    cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, megastep=False, reuse_matrices=not exact))
    env = LeggedRobotEnv(cfg, device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    counters = ((entry_cache, "normal_launches" if rough else "launches"),
                (contact, "cache_launches"),
                (dynamics, "normal_launches" if rough else "launches"),
                (entry_cache, "launches" if rough else "normal_launches"),
                (dynamics, "launches" if rough else "normal_launches"),
                (megastep, "launches"), (megastep, "normal_launches"))
    builds = envminor.cache_builds
    before = [getattr(mod, c) for mod, c in counters]
    steps, D = 3, env.cfg.control.decimation
    for _ in range(steps):
        state, obs, rew, *_ = env.step(state, torch.randn(
            (n, 12), generator=gen, device=cuda))
    torch.cuda.synchronize()
    assert envminor.cache_builds == builds
    per_step = D if exact else 1
    assert [getattr(mod, c) - b for (mod, c), b in zip(counters, before)] \
        == [steps * per_step, steps * per_step, steps * D, 0, 0, 0, 0]
    assert bool(torch.isfinite(obs["obs"]).all())
    assert bool(torch.isfinite(state.phys.base_pos).all())
    dyn = env.dynamics_params(state)[1]
    em, rh_t, n_t = entry_cache.entry_cache(env.model, state.phys, dyn,
                                            env.terrain, engine.SUBSTEP_BLOCK)
    p_em, p_rh, _, _, _, p_n = engine.build_pallas_env_inputs(
        env.model, state.phys, dyn, env.terrain, engine.SUBSTEP_BLOCK)
    assert envminor.cache_builds == builds + 1
    assert (n_t is not None) == (p_n is not None) == rough
    pairs = list(zip(em, p_em)) + ([(rh_t, p_rh), (n_t, p_n)] if rough
                                   else [])
    _close(*zip(*pairs))


@pytest.mark.parametrize("variant", ["P", "exact", "P_exact"])
def test_p_and_exact_kernels_match_plain_versions_on_the_card(cuda,
                                                              variant):
    """K4c (the team kernel in reuse mode, against its plain version fed
    the eager build) and K5, K5-P (the team kernel in exact mode, the cache
    rebuilt before every substep) against their plain versions, 10 random
    steps in: |kernel - plain| <= 2e-4 + 2e-4 |plain|; every lane finite,
    padded ones included."""
    n = 256
    cfg = small_train_cfg(n) if variant.startswith("P") else mob_train_cfg(n)
    if variant.endswith("exact"):
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, reuse_matrices=False))
    env = LeggedRobotEnv(cfg, device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    for _ in range(10):
        state, *_ = env.step(state, torch.randn((n, 12), generator=gen,
                                                device=cuda))
    args, kwargs = _call(env, state)
    p_args, p_kwargs = _call(env, state, eager_cache=True)
    exact = variant.endswith("exact")
    assert (kwargs["entry_inputs"] is None) == exact
    count = {"P": "p_launches", "exact": "exact_launches",
             "P_exact": "p_exact_launches"}[variant]
    before = getattr(megastep, count)
    out_k = megastep.control_step(*args, **kwargs)
    torch.cuda.synchronize()
    assert getattr(megastep, count) == before + 1
    assert len(out_k) == (10 if variant.startswith("P") else 14)
    out_r = megastep.control_step_reference(*p_args, **p_kwargs)
    for a, b in zip(out_k, out_r):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a[..., :n].cpu().numpy(),
                                   b[..., :n].cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


def _substep_inputs(cuda, n=256, rough=False):
    """Inputs of the three per-substep kernels 10 random steps in (on
    rough_train_cfg's heightfield with `rough`; the normals come last)."""
    env = LeggedRobotEnv((rough_train_cfg if rough else mob_train_cfg)(n),
                         device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    for _ in range(10):
        state, *_ = env.step(state, torch.randn((n, 12), generator=gen,
                                                device=cuda))
    m = env.model
    em, rh_t, mu_t, e_t, g_t, n_t = engine.build_pallas_env_inputs(
        m, state.phys, env.dynamics_params(state)[1], env.terrain,
        engine.SUBSTEP_BLOCK)
    anc_p = torch.tensor(
        np.asarray(m.anc_dof_body)[:, np.asarray(m.cp_body)].T,
        dtype=torch.float32, device=cuda).contiguous()
    p = env.sim_params
    vlim = engine._velocity_bounds(m, p, torch.float32, cuda)
    statics = dict(num_iters=p.num_contact_iters, relaxation=p.relaxation,
                   dt=p.dt, baumgarte=p.contact_baumgarte,
                   slop=p.contact_slop,
                   max_depen=p.max_depenetration_velocity,
                   bounce_thresh=p.bounce_threshold_velocity)
    gv = contact.to_env_minor(torch.cat(
        [state.phys.base_ang_vel, state.phys.base_lin_vel, state.phys.qd],
        dim=-1), engine.SUBSTEP_BLOCK)
    tau = torch.zeros_like(gv)
    tau[6:, :n] = state.torques.T
    return m, em, anc_p, rh_t, mu_t, e_t, g_t, vlim, statics, gv, tau, n_t


def _close(outs_k, outs_r):
    torch.cuda.synchronize()
    for a, b in zip(outs_k, outs_r):
        assert bool(torch.isfinite(a).all())      # padded lanes included
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


def test_contact_cache_kernel_matches_plain_version_on_the_card(cuda):
    """|kernel - plain| <= 2e-4 + 2e-4 |plain| (float32; another summation
    order in the kernel)."""
    m, em, anc_p, *_ = _substep_inputs(cuda)
    before = contact.cache_launches
    out_k = contact.build_contact_cache(anc_p, em.Sw_t, em.Sv_t, em.Minv_t,
                                        em.r_t)
    assert contact.cache_launches == before + 1
    _close(out_k, contact.cache_core(anc_p, em.Sw_t, em.Sv_t, em.Minv_t,
                                     em.r_t, eps=1e-6))


def test_contact_substep_kernel_matches_plain_version_on_the_card(cuda):
    m, em, anc_p, rh_t, mu_t, e_t, g_t, vlim, statics, gv, tau, _ = \
        _substep_inputs(cuda)
    J_t, W_t = contact.build_contact_cache(anc_p, em.Sw_t, em.Sv_t,
                                           em.Minv_t, em.r_t)
    args = (J_t, W_t, em.Minv_t, em.p_cp_t, gv, rh_t, mu_t, e_t, vlim)
    before = contact.substep_launches
    out_k = contact.contact_substep(*args, **statics)
    assert contact.substep_launches == before + 1
    out_r = contact.contact_core(*args, **statics)
    assert float(out_r[2].abs().max()) > 1e-3        # contacts active
    _close(out_k, out_r)


def test_contact_kernels_take_the_mask_and_jacobian_they_are_given(cuda):
    """K1 with an ancestor mask that sets one more column per point than the
    robot's, and K2 on the J and W of that mask (nonzeros outside the
    robot's point-dof sparsity), against their plain versions; both refuse
    a padded env count that their tile does not divide."""
    m, em, anc_p, rh_t, mu_t, e_t, g_t, vlim, statics, gv, tau, _ = \
        _substep_inputs(cuda)
    extra = anc_p.clone()
    for p in range(extra.shape[0]):
        unset = (extra[p] == 0).nonzero().flatten()
        extra[p, unset[p % len(unset)]] = 1.0
    k1 = (extra, em.Sw_t, em.Sv_t, em.Minv_t, em.r_t)
    J_t, W_t = contact.build_contact_cache(*k1)
    _close((J_t, W_t), contact.cache_core(*k1, eps=1e-6))
    args = (J_t, W_t, em.Minv_t, em.p_cp_t, gv, rh_t, mu_t, e_t, vlim)
    out_r = contact.contact_core(*args, **statics)
    assert float(out_r[2].abs().max()) > 1e-3        # contacts active
    _close(contact.contact_substep(*args, **statics), out_r)
    # 252 envs: neither 16 (K1's tile) nor 8 (K2's) divides it
    with pytest.raises(ValueError, match="not a multiple"):
        contact.build_contact_cache(extra, *(x[..., :252].contiguous()
                                             for x in k1[1:]))
    with pytest.raises(ValueError, match="not a multiple"):
        contact.contact_substep(*(x[..., :252].contiguous()
                                  for x in args[:8]), vlim, **statics)


@pytest.mark.parametrize("with_contact,rough", [(True, False), (False, False),
                                               (True, True)])
def test_dynamics_substep_kernel_matches_plain_version_on_the_card(
        cuda, with_contact, rough):
    """K3 and, on rough_train_cfg's heightfield, K3b."""
    m, em, anc_p, rh_t, mu_t, e_t, g_t, vlim, statics, gv, tau, n_t = \
        _substep_inputs(cuda, rough=rough)
    J_t, W_t = contact.build_contact_cache(anc_p, em.Sw_t, em.Sv_t,
                                           em.Minv_t, em.r_t)
    args = (em.Sw_t, em.Sv_t, em.A_t, em.B_t, em.m_t, em.Minv_t, g_t, tau,
            gv, J_t, W_t, em.p_cp_t, rh_t, mu_t, e_t, vlim, n_t)
    assert (n_t is not None) == rough
    kw = dict(anc=m.anc_dof_body, joint_body=m.joint_body, cp_body=m.cp_body,
              contact=with_contact, **statics)
    before = (dynamics.launches, dynamics.normal_launches)
    out_k = dynamics.dynamics_substep(*args, **kw)
    assert (dynamics.launches, dynamics.normal_launches) == (
        before[0] + (not rough), before[1] + rough)
    _close(out_k, dynamics.dynamics_substep_reference(*args, **kw))
    with pytest.raises(ValueError):
        dynamics.dynamics_substep(*args[:8], gv[:, :128], *args[9:], **kw)
    with pytest.raises(ValueError):                  # normals of 128 envs
        dynamics.dynamics_substep(*args[:16], em.p_cp_t[..., :128], **kw)


@pytest.mark.parametrize("reuse", [True, False])
def test_dense_route_on_the_card(cuda, reuse):
    """The dense route (stock torch ops, no hand kernel) on the card: one
    control step of 256 envs launches no kernel and builds no env-minor
    cache, and agrees with the same route on the CPU from the same state
    (both float32; another summation order in the card's products).  A
    dense substep refuses CUDA tensors while TF32 is on."""
    cfg = mob_train_cfg(256)
    cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, use_pallas_contact=False, megastep=False,
        reuse_matrices=reuse))
    env_g = LeggedRobotEnv(cfg, device=cuda)
    env_c = LeggedRobotEnv(cfg, device="cpu")
    s_c, _ = env_c.reset(make_generator(0, "cpu"))
    s_g = s_c._replace(
        phys=engine.PhysicsState(*[x.to(cuda) for x in s_c.phys]),
        rng=make_generator(1, cuda),
        **{k: getattr(s_c, k).to(cuda) for k in s_c._fields
           if k not in ("phys", "rng", "curriculum", "curriculum_eval")},
        curriculum=type(s_c.curriculum)(*[x.to(cuda)
                                          for x in s_c.curriculum]))
    before = (megastep.launches + megastep.exact_launches
              + contact.cache_launches + dynamics.launches
              + entry_cache.launches, envminor.cache_builds)
    a = torch.randn((256, 12), generator=make_generator(2, "cpu")) * 0.5
    s_c, *_ = env_c.step(s_c._replace(rng=make_generator(3, "cpu")), a)
    s_g, *_ = env_g.step(s_g, a.to(cuda))
    torch.cuda.synchronize()
    assert (megastep.launches + megastep.exact_launches
            + contact.cache_launches + dynamics.launches
            + entry_cache.launches, envminor.cache_builds) == before
    for leaf in ("base_pos", "base_quat", "q", "qd"):
        np.testing.assert_allclose(getattr(s_g.phys, leaf).cpu().numpy(),
                                   getattr(s_c.phys, leaf).numpy(),
                                   rtol=2e-4, atol=2e-4, err_msg=leaf)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            engine.physics_substep(
                env_g.model, env_g.sim_params, s_g.phys,
                torch.zeros((256, 12), device=cuda),
                env_g.dynamics_params(s_g)[1], env_g.terrain)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("eval_terrain", ["flat", "rough"])
def test_split_env_kernels_match_plain_versions_on_the_card(cuda,
                                                            eval_terrain):
    """The train/eval split (256 train + 64 eval envs, the eval slice under
    the rand_large DR preset): one K4 launch for the whole batch, and with
    the eval slice on rough_train_cfg's terrain rows one K4b launch on the
    combined 3000 x 1500 field; each against its plain version fed the
    eager build, at the tolerance of the unsplit cases."""
    from walk_these_ways_tpu_torch.learn.eval_metrics import DR_SETTINGS
    n, e = 256, 64
    ev = dataclasses.replace(mob_train_cfg(e),
                             domain_rand=DR_SETTINGS["rand_large"])
    if eval_terrain == "rough":
        ev = dataclasses.replace(ev, terrain=rough_train_cfg(e).terrain)
    env = LeggedRobotEnv(mob_train_cfg(n), eval_cfg=ev, device=cuda)
    assert env.rough == (eval_terrain == "rough")
    if env.rough:
        assert tuple(env.terrain.height.shape) == (3000, 1500)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    for _ in range(10):
        state, *_ = env.step(state, torch.randn((n + e, 12), generator=gen,
                                                device=cuda))
    args, kwargs = _call(env, state)
    p_args, p_kwargs = _call(env, state, eager_cache=True)
    counter = "normal_launches" if env.rough else "launches"
    before = getattr(megastep, counter)
    out_k = megastep.control_step(*args, **kwargs)
    torch.cuda.synchronize()
    assert getattr(megastep, counter) == before + 1
    out_r = megastep.control_step_reference(*p_args, **p_kwargs)
    for a, b in zip(out_k, out_r):
        a, b = a[..., :n + e].cpu().numpy(), b[..., :n + e].cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("eval_expert", [False, True])
def test_rma_iteration_on_the_card(cuda, eval_expert):
    """One RMA iteration (learn/ppo_rma) on 256 train + 32 eval envs: one K4
    launch a step for the whole batch, the eval slice acting with
    `student_mean` (`teacher_mean` with eval_expert), finite losses, the
    float32 learning rate in its clamps, every parameter in the main Adam
    with one step count."""
    from walk_these_ways_tpu_torch.learn import ppo, ppo_rma
    n, e, steps = 256, 32, 4
    env = LeggedRobotEnv(mob_train_cfg(n), eval_cfg=mob_train_cfg(e),
                         device=cuda)
    gen = make_generator(0, cuda)
    ts = ppo_rma.init_train_state(gen, env)
    state, obs = env.reset(gen)
    given = []
    step = env.step

    def recording_step(s, a):
        given.append(a[n:].clone())
        return step(s, a)

    env.step = recording_step
    with torch.no_grad():
        o, pv, h = (obs[k][n:] for k in ("obs", "privileged_obs",
                                         "obs_history"))
        want = (ts.policy.teacher_mean(o, pv)[0] if eval_expert
                else ts.policy.student_mean(o, h))
    before = megastep.launches
    fn = ppo_rma.make_train_iteration(env, ppo.PPO_Args(), num_steps=steps,
                                      eval_expert=eval_expert)
    state, obs, ts, m = fn(state, obs, ts)
    torch.cuda.synchronize()
    assert megastep.launches == before + steps
    assert torch.equal(given[0], want)
    for name in ("value_loss", "surrogate_loss", "adaptation_loss",
                 "mean_kl"):
        assert bool(torch.isfinite(getattr(m, name))), name
    assert np.float32(1e-5) <= np.float32(m.lr) <= np.float32(1e-2)
    assert {int(st["step"]) for st in ts.optimizer.state.values()} == {20}
    assert len(ts.optimizer.state) == len(list(ts.policy.parameters()))


def test_skeleton_points_on_the_card(cuda):
    """The video's FK skeleton of env 0 from a PhysicsState on the card
    against the same points from a copy of the state on the CPU."""
    from walk_these_ways_tpu_torch.utils import render
    env = LeggedRobotEnv(mob_train_cfg(16), device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    for _ in range(3):
        state, *_ = env.step(state, torch.randn((16, 12), generator=gen,
                                                device=cuda))
    phys_cpu = engine.PhysicsState(*[x.cpu() for x in state.phys])
    for i in (0, 15):
        p_c, f_c = render._skeleton_points(env.model, state.phys, i)
        p_h, f_h = render._skeleton_points(env.model, phys_cpu, i)
        np.testing.assert_allclose(p_c, p_h, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(f_c, f_h, rtol=1e-5, atol=1e-6)


def test_profile_train_full_iteration_on_the_card(cuda):
    """scripts/profile_train without --rollout-only on 256 envs: a warm-up,
    a timed and a traced PPO iteration, one K4 launch a step (and one for
    the reset), its rate and the traced device ops."""
    from walk_these_ways_tpu_torch.scripts import profile_train
    before = megastep.launches
    row = profile_train.main(["--num-envs", "256", "--iters", "1"])
    assert megastep.launches == before + 1 + 3 * profile_train.STEPS
    assert row["what"] == "full train iteration"
    assert row["env_steps_per_s"] > 0 and row["top_device_ops"]
    assert 0.0 < row["device_busy_share"] <= 1.0


@pytest.mark.parametrize("name", ["box_slide", "box_incline", "box_rest",
                                  "box_bounce"])
def test_box_engine_halves_on_the_card(cuda, name):
    """scripts/mujoco_parity.py's box experiments, engine halves only (the
    dense route at N = 1, `torch.linalg.inv` for the box's M^-1): on the
    card against the CPU over the first 10 substeps (2e-4 + 2e-4 |cpu|,
    impulses as F dt), and the analytic gate on the card."""
    from walk_these_ways_tpu_torch.scripts import mujoco_parity as mp
    card = mp.ENGINE_HALVES[name](cuda)
    host = mp.ENGINE_HALVES[name]("cpu")
    assert card["analytic_ok"] is True
    dt = mp.BOUNCE["DT"] if name == "box_bounce" else 0.005
    for mode, rows in host["trajs"].items():
        for a, b in zip(card["trajs"][mode][:10], rows[:10]):
            for i, (x, y) in enumerate(zip(a, b)):
                scale = dt if mp.ROW_FIELDS[i] == "report_forces" else 1.0
                np.testing.assert_allclose(x * scale, y * scale, rtol=2e-4,
                                           atol=2e-4)


def test_two_ranks_share_the_card_and_agree_with_one(cuda, tmp_path):
    """scripts/multihost_smoke on the card: 2 ranks of 128 envs of
    mob_train_cfg(256) sharing it over gloo, K4 on each, checksums equal,
    a fresh cluster resumed bit-exactly; their gathered reset and step are
    the 1-rank env's bit for bit (the curriculum's per-bin task sums,
    which the card's index_add sums in any order, to 1e-6)."""
    import os
    import pickle
    import sys
    from walk_these_ways_tpu_torch.scripts import multihost_smoke as mh
    rec = str(tmp_path / "rec")
    # 45-83 s on an H100 (nvcc builds included), under the 240 s wall limit
    p = run_group(
        [sys.executable, "-m", mh.MODULE, "--device", "cuda", "--backend",
         "gloo", "--num-processes", "2", "--num-envs", "256", "--iters", "1",
         "--num-steps", "4", "--shared-resume", "--record", rec],
        cwd=mh.ROOT, timeout=200)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-2000:]
    a = [pickle.load(open(os.path.join(rec, f"save_rank{r}.pkl"), "rb"))
         for r in range(2)]
    assert [r["launches"]["megastep.launches"] for r in a] == [5, 5]
    assert a[0]["checksum"] == a[1]["checksum"]
    env = LeggedRobotEnv(mob_train_cfg(256), device=cuda)
    one = mh.env_checks(env, 4)

    for what in ("reset", "step"):
        assert mh.differing_leaves(a[0][what], one[what], 256,
                                   close=("bin_task_sums",)) == []
