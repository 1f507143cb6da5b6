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
from walk_these_ways_tpu_torch.ops import contact, dynamics, megastep
from walk_these_ways_tpu_torch.physics import engine, envminor

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    return torch.device("cuda", 0)


def _call(env, state, eager_cache=False):
    """(args, kwargs) of the control-step call of `env.step`; with
    `eager_cache` the entry cache built on the host, as the plain version of
    K4 and K4b is fed (their kernel builds it in its launch)."""
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
    # exact mode starts every solve cold: a cross-step seed is refused
    exact_kw = dict(kwargs, entry_inputs=None, exact_inputs=(
        torch.zeros((1, args[6].shape[-1]), device=cuda),
        torch.zeros((3, args[6].shape[-1]), device=cuda)))
    with pytest.raises(ValueError):
        megastep.control_step(None, *args[1:19], args[6][:, :1].new_zeros(
            (28, 3, args[6].shape[-1])), **exact_kw)
    # exact mode is flat-ground only: normals are refused
    with pytest.raises(ValueError):
        megastep.control_step(None, *args[1:5], normals, *args[6:19], None,
                              **exact_kw)


@pytest.mark.parametrize("control_type", ["actuator_net", "P"])
def test_normals_kernel_matches_plain_version_on_the_card(cuda,
                                                          control_type):
    """K4b (the team kernel: entry cache and heightfield samples in its
    launch) and K4b-P (cache and normals built on the host) on
    rough_train_cfg, 10 random steps in, against the plain version fed the
    eager build: |kernel - plain| <= 2e-4 + 2e-4 |plain|; every lane
    finite, padded ones included."""
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
    team = control_type == "actuator_net"
    assert (kwargs["entry_inputs"] is not None) == team
    counters = ("launches", "p_launches", "normal_launches",
                "p_normal_launches")
    before = [getattr(megastep, c) for c in counters]
    out_k = megastep.control_step(*args, **kwargs)
    torch.cuda.synchronize()
    assert [getattr(megastep, c) - b for c, b in zip(counters, before)] == (
        [0, 0, 1, 0] if team else [0, 0, 0, 1])
    out_r = megastep.control_step_reference(*p_args, **p_kwargs)
    for a, b in zip(out_k, out_r):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a[..., :n].cpu().numpy(),
                                   b[..., :n].cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("route", ["flat", "rough", "rough_exact"])
def test_team_kernel_routes_make_no_eager_cache_build_on_the_card(cuda,
                                                                  route):
    """The default route (K4), the rough default route (K4b) and the rough
    exact route (`decimation` K4b launches of one substep) build their
    entry cache in the launch: no eager build; every output finite."""
    n = 256
    cfg = mob_train_cfg(n) if route == "flat" else rough_train_cfg(n)
    if route == "rough_exact":
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, reuse_matrices=False))
    env = LeggedRobotEnv(cfg, device=cuda)
    gen = make_generator(0, cuda)
    state, _ = env.reset(gen)
    counter = "launches" if route == "flat" else "normal_launches"
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


@pytest.mark.parametrize("variant", ["P", "exact", "P_exact"])
def test_p_and_exact_kernels_match_plain_versions_on_the_card(cuda,
                                                              variant):
    """K4c and K5 (either torque model) against their plain versions, 10
    random steps in: |kernel - plain| <= 2e-4 + 2e-4 |plain|; every lane
    finite, padded ones included."""
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
    count = "exact_launches" if variant.endswith("exact") else "p_launches"
    before = getattr(megastep, count)
    out_k = megastep.control_step(*args, **kwargs)
    torch.cuda.synchronize()
    assert getattr(megastep, count) == before + 1
    assert len(out_k) == (10 if variant.startswith("P") else 14)
    out_r = megastep.control_step_reference(*args, **kwargs)
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
