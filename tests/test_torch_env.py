"""The slice as a whole: `LeggedRobotEnv.step` of the port vs the JAX package.

The JAX env is reset once; its state is converted leaf by leaf (numpy) into
the port's EnvState; both are stepped with the same actions.  Observation
noise is off, pushes are off in this config, and no DR refresh, gravity
redraw, command resample or reset falls inside the compared steps, so no
random draw reaches a compared quantity.

On the JAX side `pl.pallas_call` is replaced, inside this module only, by an
eager runner of the kernel body (input arrays as the refs, a box per output
ref), its dynamics and contact cores jitted (`_jit_kernel_cores`): the same
arithmetic as the TPU kernel without interpret mode.  So the comparison is
tight: rtol 1e-4 / atol 1e-4 after 3 control steps (12 physics substeps of
float32 rounding differences); contact forces are impulses / dt (x200) and
get atol 2e-2 N.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu import go1_config as j_cfg
from walk_these_ways_tpu.envs import go1_env as j_env
from walk_these_ways_tpu.ops import pallas_megastep as j_pm

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import go1_env as t_env
from walk_these_ways_tpu_torch.utils import convert

from test_torch_util import assert_close

torch.set_num_threads(1)
N, STEPS = 16, 3
RTOL, ATOL = 1e-4, 1e-4


class _Box:
    def __setitem__(self, idx, value):
        self.value = value


def _eager_pallas_call(kernel, *, out_shape, **_):
    """Stands in for pl.pallas_call: runs the kernel body eagerly on whole
    arrays."""
    def run(*inputs):
        boxes = [_Box() for _ in out_shape]
        kernel(*inputs, *boxes)
        return tuple(b.value for b in boxes)
    return run


def _jit_kernel_cores(mp):
    """Inside the MonkeyPatch `mp`, the JAX package's in-kernel cores
    (`pallas_dynamics.dyn_core`, `pallas_contact.contact_core`) become
    jitted copies, compiled once per set of static arguments: the kernel
    body run eagerly then compiles each core once instead of each of its
    thousands of operations, and runs it as one program.  The arrays `n`
    and `lam0` stay traced arguments."""
    def jitted(fn):
        cache = {}

        def call(*args, **kw):
            traced = {k: kw.pop(k) for k in ("n", "lam0")
                      if kw.get(k) is not None}
            key = (tuple(sorted(traced)),) + tuple(sorted(
                (k, (v.shape, v.dtype.str, v.tobytes())
                 if isinstance(v, np.ndarray) else repr(v))
                for k, v in kw.items()))
            if key not in cache:
                cache[key] = jax.jit(
                    lambda a, d, static=dict(kw): fn(*a, **static, **d))
            return cache[key](args, traced)
        return call

    mp.setattr(j_pm.pd, "dyn_core", jitted(j_pm.pd.dyn_core))
    mp.setattr(j_pm.pc, "contact_core", jitted(j_pm.pc.contact_core))


def _to_numpy_state(s):
    out = {}
    for name in s._fields:
        v = getattr(s, name)
        if name == "rng":
            continue
        if v is None:
            out[name] = None
        elif name in ("phys", "curriculum", "curriculum_eval"):
            out[name] = {k: np.asarray(x) for k, x in v._asdict().items()}
        else:
            out[name] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs():
    def quiet(cfg):
        return dataclasses.replace(
            cfg, noise=dataclasses.replace(cfg.noise, add_noise=False))

    mp = pytest.MonkeyPatch()
    mp.setattr(j_pm.pl, "pallas_call", _eager_pallas_call)
    _jit_kernel_cores(mp)
    try:
        envj = j_env.LeggedRobotEnv(quiet(j_cfg.mob_train_cfg(N)))
        sj, oj = envj.reset(jax.random.PRNGKey(0))
        envt = t_env.LeggedRobotEnv(quiet(t_cfg.mob_train_cfg(N)),
                                    device="cpu")
        st = convert.env_state_from_numpy(
            _to_numpy_state(sj), t_env.make_generator(0, "cpu"), device="cpu")
        start = (sj, st)
        rs = np.random.RandomState(9)
        steps = []
        for _ in range(STEPS):
            a = (0.5 * rs.randn(N, 12)).astype(np.float32)
            sj_prev, st_prev = sj, st
            sj, oj, rj, dj, ij = envj.step(sj, jnp.asarray(a))
            st, ot, rt, dt_, it = envt.step(st, torch.from_numpy(a))
            steps.append(dict(j=(sj, oj, rj, dj, ij), t=(st, ot, rt, dt_, it),
                              prev=(sj_prev, st_prev)))
    finally:
        mp.undo()
    return envj, envt, start, steps


def test_env_constants_match(runs):
    envj, envt, (sj0, st0), _ = runs
    for name in ("env_origins", "default_dof_pos", "torque_limits",
                 "dof_pos_limits", "commands_scale", "noise_scale_vec",
                 "task_thresholds"):
        assert_close(getattr(envt, name), getattr(envj, name), 1e-6, 1e-7,
                     err_msg=name)
    assert envt.reward_names == envj.reward_names
    np.testing.assert_allclose(envt.reward_scales, envj.reward_scales)
    for name in ("resample_interval", "rand_interval", "push_interval",
                 "gravity_rand_interval", "gravity_rand_duration",
                 "max_episode_length", "num_obs_history", "feet_indices",
                 "penalised_indices"):
        assert getattr(envt, name) == getattr(envj, name), name
    # the converted state holds every leaf of the JAX state
    assert set(st0._fields) == set(sj0._fields)
    assert tuple(st0.contact_lam_t.shape) == sj0.contact_lam_t.shape
    assert float(np.abs(np.asarray(sj0.contact_lam_t)).max()) > 0


@pytest.mark.parametrize("key", ["obs", "privileged_obs", "obs_history"])
def test_observations_match(runs, key):
    for k, step in enumerate(runs[3]):
        assert_close(step["t"][1][key], step["j"][1][key], RTOL, ATOL,
                     err_msg=f"step {k}")


def test_rewards_done_and_info_match(runs):
    for k, step in enumerate(runs[3]):
        (_, _, rj, dj, ij), (_, _, rt, dt_, it) = step["j"], step["t"]
        assert_close(rt, rj, RTOL, ATOL, err_msg=f"reward step {k}")
        np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
        np.testing.assert_array_equal(it.time_outs.numpy(),
                                      np.asarray(ij.time_outs))
        assert_close(it.torques, ij.torques, RTOL, 1e-3)
        assert float(it.envelope_exits) == float(ij.envelope_exits)
        assert int(it.ep_count_done) == int(ij.ep_count_done)


def test_per_term_rewards_match(runs):
    """episode_sums grows by each scaled reward term (and the total) every
    step: its increment is the per-term reward."""
    envj, envt, _, steps = runs
    for k, step in enumerate(steps):
        assert not bool(step["t"][3].any())       # no reset in these steps
        dj = np.asarray(step["j"][0].episode_sums) \
            - np.asarray(step["prev"][0].episode_sums)
        dt_ = (step["t"][0].episode_sums - step["prev"][1].episode_sums).numpy()
        for i, name in enumerate(envt.reward_names + ("total",)):
            np.testing.assert_allclose(dt_[:, i], dj[:, i], rtol=1e-3,
                                       atol=1e-4, err_msg=f"{name} step {k}")
        assert np.abs(dj).max() > 0


STATE_LEAVES = [
    "actions", "last_actions", "last_last_actions", "joint_pos_target",
    "last_joint_pos_target", "last_last_joint_pos_target", "last_dof_vel",
    "lag_buffer", "torques", "joint_pos_err_last", "joint_pos_err_last_last",
    "joint_vel_last", "joint_vel_last_last", "episode_length", "common_step",
    "commands", "gait_indices", "clock_inputs", "desired_contact_states",
    "foot_indices", "contact_forces", "foot_positions", "foot_velocities",
    "prev_foot_velocities", "last_contacts", "payloads", "com_displacements",
    "friction_coeffs", "restitutions", "motor_strengths", "motor_offsets",
    "Kp_factors", "Kd_factors", "gravity_offset", "episode_sums",
    "command_sums", "env_command_bins", "env_command_categories",
    "contact_lam_t"]
LOOSE = {"contact_forces": 2e-2, "torques": 1e-3, "foot_velocities": 1e-3,
         "prev_foot_velocities": 1e-3, "joint_vel_last": 1e-3,
         "joint_vel_last_last": 1e-3, "last_dof_vel": 1e-3}


@pytest.mark.parametrize("leaf", STATE_LEAVES)
def test_state_leaf_matches_after_steps(runs, leaf):
    sj, st = runs[3][-1]["j"][0], runs[3][-1]["t"][0]
    a, b = getattr(st, leaf), np.asarray(getattr(sj, leaf))
    assert tuple(a.shape) == b.shape
    if b.dtype == bool or np.issubdtype(b.dtype, np.integer):
        np.testing.assert_array_equal(a.numpy(), b)
    else:
        assert_close(a, b, RTOL, LOOSE.get(leaf, ATOL), err_msg=leaf)


@pytest.mark.parametrize("leaf", ["base_pos", "base_quat", "base_lin_vel",
                                  "base_ang_vel", "q", "qd"])
def test_physics_state_matches_after_steps(runs, leaf):
    sj, st = runs[3][-1]["j"][0], runs[3][-1]["t"][0]
    assert_close(getattr(st.phys, leaf), getattr(sj.phys, leaf), RTOL,
                 1e-3 if leaf in ("qd", "base_ang_vel") else ATOL,
                 err_msg=leaf)


@pytest.mark.parametrize("leaf", ["weights", "bin_task_sums", "bin_ep_counts"])
def test_curriculum_matches_after_steps(runs, leaf):
    sj, st = runs[3][-1]["j"][0], runs[3][-1]["t"][0]
    assert_close(getattr(st.curriculum, leaf), getattr(sj.curriculum, leaf),
                 1e-6, 1e-7, err_msg=leaf)


def test_masked_reset_and_resample_stay_finite(runs):
    """Port only: a terminated env is re-initialised, an env at its
    resampling time gets new commands, the others are left alone."""
    _, envt, _, steps = runs
    st = steps[-1]["t"][0]
    pos = st.phys.base_pos.clone()
    pos[1, 2] = 0.02                               # below terminal height
    ep = st.episode_length.clone()
    ep[2] = envt.resample_interval - 1             # resamples this step
    lam = st.contact_lam_t.clone()
    lam[:, :, :N] += 0.01
    s0 = st._replace(phys=st.phys._replace(base_pos=pos), episode_length=ep,
                     contact_lam_t=lam)
    s1, obs, rew, done, info = envt.step(s0, torch.zeros(N, 12))
    assert bool(done[1]) and int(done.sum()) == 1
    assert int(info.ep_count_done) == 1
    assert int(s1.episode_length[1]) == 0
    assert int(s1.episode_length[2]) == envt.resample_interval
    assert abs(float(s1.phys.base_pos[1, 2]) - 0.34) < 1e-6
    assert float(s1.contact_lam_t[:, :, 1].abs().max()) == 0.0
    assert float(s1.contact_lam_t[:, :, 0].abs().max()) > 0.0
    assert float(s1.episode_sums[1].abs().max()) == 0.0
    assert float(s1.lag_buffer[1].abs().max()) == 0.0
    for i in (1, 2):
        assert not torch.equal(s1.commands[i], s0.commands[i])
    # the reset env's sums are cleared after the rewards were added, the
    # resampled env's before: it has counted this one step since
    assert float(s1.command_sums[1].abs().max()) == 0.0
    assert float(s1.command_sums[2, -1]) == 1.0
    keep = [i for i in range(N) if i not in (1, 2)]
    assert torch.equal(s1.commands[keep], s0.commands[keep])
    # sampled commands lie inside the curriculum's limits
    lo = torch.tensor(envt.cfg.commands.limits_low)
    hi = torch.tensor(envt.cfg.commands.limits_high)
    assert bool(((s1.commands[1] >= lo - 1e-5)
                 & (s1.commands[1] <= hi + 1e-5))[[0, 2, 3, 4, 9]].all())
    for v in list(obs.values()) + [rew, s1.phys.q, s1.phys.base_quat,
                                   s1.obs_history, s1.curriculum.weights]:
        assert bool(torch.isfinite(v).all())
    # one generator drives every draw: the same seed gives the same step
    s0b = s0._replace(rng=t_env.make_generator(3, "cpu"))
    s0c = s0._replace(rng=t_env.make_generator(3, "cpu"))
    a, b = envt.step(s0b, torch.zeros(N, 12)), envt.step(s0c, torch.zeros(N, 12))
    assert torch.equal(a[0].commands, b[0].commands)
    assert torch.equal(a[0].phys.q, b[0].phys.q)


def test_unported_branches_raise():
    cfg = t_cfg.mob_train_cfg(4)
    # the dense physics branches run (sim.use_pallas_contact off, whatever
    # sim.megastep says): the env constructs and steps; so do the
    # per-substep route and exact mode inside the control-step kernel
    dense = t_env.LeggedRobotEnv(dataclasses.replace(
        cfg, sim=dataclasses.replace(cfg.sim, use_pallas_contact=False)),
        device="cpu")
    s, _ = dense.reset(0)
    s, _, _, _, info = dense.step(s, torch.zeros(4, 12))
    assert bool(torch.isfinite(s.phys.q).all())
    assert float(s.contact_forces.abs().max()) > 1.0
    t_env.LeggedRobotEnv(dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, reuse_matrices=False)), device="cpu")
    # the train/eval split is ported: an eval slice may differ only in
    # domain_rand, commands, terrain and num_envs
    split = t_env.LeggedRobotEnv(cfg, eval_cfg=t_cfg.mob_train_cfg(2),
                                 device="cpu")
    assert (split.num_envs, split.num_train_envs, split.num_eval_envs) == (
        6, 4, 2)
    with pytest.raises(ValueError, match="may differ"):
        t_env.LeggedRobotEnv(cfg, eval_cfg=t_cfg.small_train_cfg(2),
                             device="cpu")
    # rough terrain is ported: a heightfield with its corner-packed table
    rough = t_env.LeggedRobotEnv(t_cfg.rough_train_cfg(4), device="cpu")
    assert rough.rough and tuple(rough.terrain.height.shape) == (1500, 1500)
    assert tuple(rough.terrain.corners.shape) == (1499, 1499, 4)
    assert not t_env.LeggedRobotEnv(cfg, device="cpu").rough


def test_rollout_and_reference_api_adapter_on_cpu():
    """Port only: `learn/rollout.rollout` and the reference-API adapter run
    end to end at a tiny size, with every draw from the given generator."""
    from walk_these_ways_tpu_torch.learn.rollout import rollout
    from walk_these_ways_tpu_torch.models.actor_critic import ActorCritic
    from walk_these_ways_tpu_torch.velocity_tracking import \
        VelocityTrackingEasyEnv
    n, steps = 4, 2
    env = t_env.LeggedRobotEnv(t_cfg.mob_train_cfg(n), device="cpu")

    def run(seed):
        gen = t_env.make_generator(seed, "cpu")
        pol = ActorCritic(env.num_obs, env.num_privileged_obs,
                          env.num_obs_history, env.num_actions,
                          generator=gen, device="cpu")
        return rollout(env, pol, steps, gen)

    state, obs, ro = run(0)
    assert tuple(ro.actions.shape) == (steps, n, 12)
    assert tuple(ro.obs_history.shape) == (steps, n, 2100)
    assert tuple(ro.rewards.shape) == tuple(ro.values.shape) == (steps, n)
    assert ro.dones.dtype == torch.bool
    assert int(state.common_step) == steps + 1          # reset steps once
    for v in (ro.actions, ro.log_probs, ro.values, ro.rewards,
              obs["obs_history"], state.phys.q):
        assert bool(torch.isfinite(v).all())
    assert torch.equal(obs["obs_history"][:, -70:], obs["obs"])
    _, _, ro2 = run(0)
    assert torch.equal(ro.actions, ro2.actions)
    assert torch.equal(ro.rewards, ro2.rewards)
    _, _, ro3 = run(1)
    assert not torch.equal(ro.actions, ro3.actions)

    venv = VelocityTrackingEasyEnv(env, seed=0)
    o = venv.reset()
    o, rew, done, extras = venv.step(np.zeros((n, 12), np.float32))
    assert set(o) == {"obs", "privileged_obs", "obs_history"}
    for key in ("privileged_obs", "joint_pos", "joint_vel",
                "joint_pos_target", "joint_vel_target", "body_linear_vel",
                "body_angular_vel", "body_linear_vel_cmd",
                "body_angular_vel_cmd", "contact_states", "foot_positions",
                "body_pos", "torques"):
        assert key in extras, key
    assert extras["joint_pos"].shape == (n, 12)
    assert extras["contact_states"].dtype == bool
    assert venv.num_envs == n and venv.get_observations() is o
