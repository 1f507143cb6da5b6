"""The train/eval env split, the eval metrics library and the evaluation
entry points of the port vs the JAX package, on the CPU.

One split config in both packages: `mob_train_cfg`, 8 train + 4 eval envs,
the dense physics (`conftest.xla_physics`; the port's dense route on CPU
tensors), observation noise off.  The eval slice differs from the train
slice in all three sections the split allows: `domain_rand` (the
`rand_large` preset), `commands` (forward-only x velocity over 5 bins, a
4 s resampling time) and `terrain` (4 x 4 tiles of `rough_train_cfg`'s
rough terrain, appended after the 1500 x 1500 train field: a 1700 x 1500
heightfield).

- Set-up: the per-split DR ranges, the combined heightfield and the env
  origins (the same numpy draws: bit for bit), the resampling cadence and
  the eval curriculum grid; per-split command bounds after a full resample
  (mirror of tests/test_env.py::test_eval_split_commands_and_terrain_divergence).
- Stepping: 3 control steps of both envs from one state (the port's reset,
  converted into the JAX package's EnvState) with the same actions, one
  train and one eval env timed out in the last step: physics, obs,
  rewards, the train and eval episode sums.
- `collect` with eval envs: the eval actions are JAX's `actor_mean` (or
  `act_teacher` with `eval_expert`) on the same weights; the trajectory
  holds the train envs only (mirror of
  tests/test_ppo.py::test_train_eval_env_split).
- Every `METRICS_FNS` entry on one converted state against the JAX function,
  `DR_SETTINGS` field by field, `evaluate_policy` (mirror of
  tests/test_eval_metrics.py).
- The runner with eval envs and `eval_expert` (the JAX runner's
  `eval/episode/*` keys, `curriculum_eval` through a checkpoint), the train
  script's eval flags and `scripts.evaluate` with device="cpu".

The JAX step and the JAX metrics are jitted once each.  Random streams are
not matched: no compared quantity depends on a draw.
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
from walk_these_ways_tpu.envs import curriculum as j_curr
from walk_these_ways_tpu.envs import go1_env as j_env
from walk_these_ways_tpu.learn import eval_metrics as j_em
from walk_these_ways_tpu.models import actor_critic as j_ac
from walk_these_ways_tpu.physics import engine as j_engine

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import curriculum as t_curr
from walk_these_ways_tpu_torch.envs import go1_env as t_env
from walk_these_ways_tpu_torch.learn import eval_metrics as t_em
from walk_these_ways_tpu_torch.learn import ppo as t_ppo
from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs
from walk_these_ways_tpu_torch.scripts import evaluate as t_evaluate
from walk_these_ways_tpu_torch.scripts import train as t_train
from walk_these_ways_tpu_torch.utils import convert

from test_torch_actor_critic import _flatten
from test_torch_env import _to_numpy_state
from test_torch_runner import _jax_runner_row_keys
from test_torch_util import assert_close

torch.set_num_threads(1)
T_ENVS, E_ENVS = 8, 4
N = T_ENVS + E_ENVS
STEPS = 3
TIMED_OUT = (1, T_ENVS + 1)      # one train and one eval env, last step
PHYS_LEAVES = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
               "q", "qd")


def _split_cfgs(pkg, dr_settings):
    """(cfg, eval_cfg) of one package: dense physics, noise off; the eval
    slice with its own DR preset, commands and rough terrain rows."""
    def quiet(cfg):
        return xla_physics(dataclasses.replace(
            cfg, noise=dataclasses.replace(cfg.noise, add_noise=False)))

    cfg = quiet(pkg.mob_train_cfg(T_ENVS))
    ev = quiet(pkg.mob_train_cfg(E_ENVS))
    ev = dataclasses.replace(
        ev, domain_rand=dr_settings["rand_large"],
        commands=dataclasses.replace(ev.commands, limit_vel_x=(0.5, 2.0),
                                     num_bins_vel_x=5, resampling_time=4.0),
        terrain=dataclasses.replace(pkg.rough_train_cfg(E_ENVS).terrain,
                                    num_rows=4, num_cols=4))
    return cfg, ev


def _to_jax_state(st):
    """A port EnvState as the JAX package's, leaf by leaf (numpy)."""
    d = convert.env_state_to_numpy(st)
    nested = dict(phys=j_engine.PhysicsState,
                  curriculum=j_curr.CurriculumState,
                  curriculum_eval=j_curr.CurriculumState)
    out = {}
    for name in j_env.EnvState._fields:
        v = d[name]
        if name == "rng":
            out[name] = jax.random.PRNGKey(5)
        elif v is None:
            out[name] = None
        elif name in nested:
            out[name] = nested[name](**{k: jnp.asarray(x)
                                        for k, x in v.items()})
        else:
            out[name] = jnp.asarray(v)
    return j_env.EnvState(**out)


@pytest.fixture(scope="module")
def split():
    """Both split envs, the port's reset carried into a JAX state, STEPS
    control steps of both from it, the policies on the same weights and
    every JAX metric on the JAX state after the first step."""
    cfg_j, ev_j = _split_cfgs(j_cfg, j_em.DR_SETTINGS)
    envj = j_env.LeggedRobotEnv(cfg_j, eval_cfg=ev_j)
    cfg_t, ev_t = _split_cfgs(t_cfg, t_em.DR_SETTINGS)
    envt = t_env.LeggedRobotEnv(cfg_t, eval_cfg=ev_t, device="cpu")
    step_j = jax.jit(envj.step)
    # the start: the port's reset, carried into a JAX state
    st, ot = envt.reset(t_env.make_generator(3, "cpu"))
    sj, oj = _to_jax_state(st), {k: jnp.asarray(v.numpy())
                                 for k, v in ot.items()}
    start = (sj, oj, st)
    rs = np.random.RandomState(9)
    steps = []
    for k in range(STEPS):
        if k == STEPS - 1:
            # one train and one eval env time out in this step
            ep = np.asarray(sj.episode_length).copy()
            ep[list(TIMED_OUT)] = envj.max_episode_length
            sj = sj._replace(episode_length=jnp.asarray(ep))
            st = st._replace(episode_length=torch.from_numpy(ep))
        a = (0.5 * rs.randn(N, 12)).astype(np.float32)
        sj, oj2, rj, dj, ij = step_j(sj, jnp.asarray(a))
        st, ot, rt, dt_, it = envt.step(st, torch.from_numpy(a))
        steps.append(((sj, oj2, rj, dj, ij), (st, ot, rt, dt_, it)))
    pj = jax.jit(j_ac.init, static_argnums=(1, 2, 3, 4))(
        jax.random.PRNGKey(1), envj.num_obs, envj.num_privileged_obs,
        envj.num_obs_history, envj.num_actions)
    pt = convert.actor_critic_from_numpy(_flatten(pj), device="cpu")
    # every JAX metric on the JAX state after the first step, in one program
    sj1, oj1 = steps[0][0][:2]
    metrics_j = jax.jit(lambda s, p, o: {
        k: f(envj, s, p, o) for k, f in j_em.METRICS_FNS.items()})(
            sj1, pj, oj1)
    return dict(envj=envj, envt=envt, start=start, steps=steps, pj=pj,
                pt=pt, metrics_j=metrics_j)


# -- set-up -----------------------------------------------------------------


DR_FIELDS = [("randomize_friction", "friction_range"),
             ("randomize_base_mass", "added_mass_range"),
             ("randomize_com_displacement", "com_displacement_range"),
             ("randomize_motor_strength", "motor_strength_range"),
             ("randomize_Kp_factor", "Kp_factor_range")]


@pytest.mark.parametrize("flag,rng", DR_FIELDS)
def test_dr_split_matches_jax(split, flag, rng):
    """The per-env (lo, hi, on) arrays bit for bit, and the eval slice's
    reset values inside its own range."""
    envj, envt = split["envj"], split["envt"]
    for a, b in zip(envt._dr_split(flag, rng), envj._dr_split(flag, rng)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    lo, hi, on = (x.numpy() for x in envt._dr_split(flag, rng))
    assert on[T_ENVS:].all() == bool(getattr(t_em.DR_SETTINGS["rand_large"],
                                             flag))
    if rng == "friction_range":
        fr = split["start"][2].friction_coeffs.numpy()
        assert ((fr[T_ENVS:] >= lo[T_ENVS:]) & (fr[T_ENVS:] <= hi[T_ENVS:])
                ).all()
        assert lo[0] != lo[-1] and hi[0] != hi[-1]


def test_split_terrain_and_curriculum_match_jax(split):
    envj, envt = split["envj"], split["envt"]
    assert (envt.num_train_envs, envt.num_eval_envs, envt.num_envs) == (
        T_ENVS, E_ENVS, N)
    assert envt.eval_commands_differ and envt.eval_terrain_differs
    np.testing.assert_array_equal(envt.terrain.height.numpy(),
                                  np.asarray(envj.terrain.height))
    assert tuple(envt.terrain.height.shape) == (1700, 1500) and envt.rough
    assert envt.terrain.horizontal_scale == envj.terrain.horizontal_scale
    assert tuple(envt.terrain.origin_xy) == tuple(envj.terrain.origin_xy)
    np.testing.assert_array_equal(envt.env_origins.numpy(),
                                  np.asarray(envj.env_origins))
    # the eval envs spawn on the appended rows, beyond the train rows in x
    x = envt.env_origins[:, 0]
    assert float(x[T_ENVS:].min()) > float(x[:T_ENVS].max())
    np.testing.assert_array_equal(envt.resample_interval_arr.numpy(),
                                  np.asarray(envj.resample_interval_arr))
    assert int(envt.resample_interval_arr[-1]) == 200
    for name in ("grid", "bin_sizes", "adjacency"):
        np.testing.assert_array_equal(getattr(envt.curr_grid_eval, name),
                                      getattr(envj.curr_grid_eval, name))
    # the eval curriculum both envs start from
    ct = t_curr.init_state(envt.eval_cfg.commands, envt.curr_grid_eval,
                           device="cpu")
    cj = j_curr.init_state(envj.eval_cfg.commands, envj.curr_grid_eval)
    for leaf in ("weights", "bin_task_sums", "bin_ep_counts"):
        np.testing.assert_array_equal(getattr(ct, leaf).numpy(),
                                      np.asarray(getattr(cj, leaf)))
    assert split["start"][2].curriculum_eval.weights.shape == \
        ct.weights.shape != split["start"][2].curriculum.weights.shape


def test_per_split_command_bounds_after_a_full_resample(split):
    """A resample of every env draws each slice from its own grid: the eval
    x velocities in [0.5, 2], the train ones within the train limits; the
    eval curriculum has the eval grid's bin count."""
    envt = split["envt"]
    st = split["start"][2]
    s = envt._resample_commands(st, torch.ones(N, dtype=torch.bool),
                                t_env.make_generator(7, "cpu"))
    vx = s.commands[:, 0].numpy()
    assert (vx[T_ENVS:] >= 0.5 - 1e-5).all() and (vx[T_ENVS:] <= 2.0 + 1e-5
                                                  ).all(), vx
    assert (vx[:T_ENVS] >= -10.0 - 1e-5).all() and (vx[:T_ENVS] <= 10.0 + 1e-5
                                                    ).all()
    assert s.curriculum_eval.weights.shape != s.curriculum.weights.shape
    assert int(s.env_command_bins[T_ENVS:].max()) < \
        envt.curr_grid_eval.num_bins


# -- stepping -----------------------------------------------------------------


STEP_KEYS = PHYS_LEAVES + ("obs", "reward", "done", "torques",
                           "contact_forces", "foot_positions",
                           "foot_velocities")
# rtol 1e-4 and atol 1e-5, the tolerance of tests/test_torch_dense.py's env
# case without its floors: over the 3 steps here (12 envs, 4 of them on the
# rough rows) the largest excess over rtol 1e-4 is 7.3e-6 (torques; qd
# 2.8e-7, foot positions and velocities, obs and rewards below 1e-7;
# x86-64 CPU, one thread).
STEP_ATOL = 1e-5


@pytest.mark.parametrize("key", STEP_KEYS)
def test_split_env_matches_jax_env(split, key):
    """Every step over the envs the last step did not reset (those draw a
    fresh state from another random stream)."""
    keep = np.ones(N, bool)
    for k, ((sj, oj, rj, dj, ij), (st, ot, rt, dt_, it)) in enumerate(
            split["steps"]):
        if k == STEPS - 1:
            keep[list(TIMED_OUT)] = False
            np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
            assert dt_.numpy()[list(TIMED_OUT)].all()
        msg = f"{key} step {k}"
        if key in PHYS_LEAVES:
            a, b = getattr(st.phys, key), getattr(sj.phys, key)
        elif key == "obs":
            a, b = ot["obs"], oj["obs"]
        elif key == "reward":
            a, b = rt, rj
        elif key == "done":
            np.testing.assert_array_equal(dt_.numpy(), np.asarray(dj))
            continue
        elif key == "torques":
            a, b = it.torques, ij.torques
        else:
            a, b = getattr(st, key), getattr(sj, key)
        assert_close(a[keep], np.asarray(b)[keep], 1e-4, STEP_ATOL,
                     err_msg=msg)
    assert float(st.contact_forces.abs().max()) > 1.0


@pytest.mark.parametrize("key", ["ep_sums_done", "ep_count_done",
                                 "ep_len_done", "eval_ep_sums_done",
                                 "eval_ep_count_done", "eval_ep_len_done"])
def test_split_episode_sums_match_jax(split, key):
    """The train and eval slices' finished-episode sums of every step; in
    the last one each slice finishes one episode."""
    for k, ((_, _, _, _, ij), (_, _, _, _, it)) in enumerate(split["steps"]):
        a, b = getattr(it, key), np.asarray(getattr(ij, key))
        assert tuple(a.shape) == b.shape
        assert_close(a.to(torch.float32), b.astype(np.float32), 1e-5, 1e-6,
                     err_msg=f"{key} step {k}")
    last = split["steps"][-1][1][4]
    assert int(last.ep_count_done) == int(last.eval_ep_count_done) == 1
    assert float(last.eval_ep_len_done) == split["envt"].max_episode_length + 1


ROUTES = {"control_step": {}, "p_control": None, "exact":
          dict(reuse_matrices=False), "substep": dict(megastep=False),
          "substep_exact": dict(megastep=False, reuse_matrices=False)}


@pytest.mark.parametrize("route", list(ROUTES))
def test_every_kernel_route_steps_the_split_env(route):
    """The split lives outside physics: each kernel route (its plain
    versions on CPU tensors) resets, which takes a step, 4 + 2 envs whose
    slices differ in DR and commands; on the first, the reference-API
    adapter reads the split's sizes and steps it."""
    from walk_these_ways_tpu_torch.envs.wrappers import VecEnvAdapter
    fn = (t_cfg.small_train_cfg if ROUTES[route] is None
          else t_cfg.mob_train_cfg)
    cfg, ev = fn(4), fn(2)
    sim = dataclasses.replace(cfg.sim, **(ROUTES[route] or {}))
    ev = dataclasses.replace(
        ev, sim=sim, domain_rand=t_em.DR_SETTINGS["static_high"],
        commands=dataclasses.replace(ev.commands, limit_vel_x=(0.5, 2.0)))
    env = t_env.LeggedRobotEnv(dataclasses.replace(cfg, sim=sim),
                               eval_cfg=ev, device="cpu")
    state, obs = env.reset(t_env.make_generator(1, "cpu"))
    if route == "control_step":
        venv = VecEnvAdapter(env, seed=1)
        assert (venv.num_train_envs, venv.num_eval_envs, venv.num_envs) == (
            4, 2, 6)
        venv.reset()
        obs, rew, done, info = venv.step(torch.full((6, 12), 0.1))
        state = venv.state
        assert tuple(rew.shape) == (6,)
        assert tuple(info.eval_ep_sums_done.shape) == (
            len(env.reward_names) + 1,)
    fr = state.friction_coeffs
    assert bool(((fr[4:] >= 4.49) & (fr[4:] <= 4.5)).all())
    assert bool((state.commands[4:, 0] >= 0.5 - 1e-5).all())
    assert tuple(obs["obs"].shape) == (6, 70)
    for v in (state.phys.q, state.phys.base_pos, obs["obs"]):
        assert bool(torch.isfinite(v).all())


# -- deterministic eval actions ---------------------------------------------


@pytest.mark.parametrize("eval_expert", [False, True])
def test_collect_eval_actions_are_the_deterministic_heads(split, eval_expert):
    """Two steps of `collect`: the eval envs' actions are JAX's actor_mean
    (act_teacher with eval_expert) of their observations, on the same
    weights; the trajectory and the rewards cover the train envs only."""
    envt, pj, pt = split["envt"], split["pj"], split["pt"]
    _, _, st = split["start"]
    ot = {k: torch.from_numpy(np.array(v))
          for k, v in split["start"][1].items()}
    head = (jax.jit(j_ac.act_teacher) if eval_expert
            else jax.jit(j_ac.actor_mean))
    gen = t_env.make_generator(4, "cpu")
    for _ in range(2):
        hist = ot["obs_history"][T_ENVS:].numpy()
        priv = ot["privileged_obs"][T_ENVS:].numpy()
        want = head(pj, hist, priv) if eval_expert else head(pj, hist)
        st, ot, traj, logs = t_ppo.collect(envt, st, ot, pt, gen, 1, 0.99,
                                           eval_expert)
        assert float(np.abs(np.asarray(want)).max()) < 10.0   # unclipped
        assert_close(st.actions[T_ENVS:], want, 1e-5, 1e-6)
        assert tuple(traj.actions.shape) == (1, T_ENVS, 12)
        assert tuple(traj.obs_history.shape) == (1, T_ENVS, 2100)
        for col in (traj.rewards, traj.values, traj.dones, traj.log_probs):
            assert tuple(col.shape) == (1, T_ENVS)
        assert torch.equal(st.actions[:T_ENVS], traj.actions[0])
        assert tuple(logs[3].shape) == (1, len(envt.reward_names) + 1)


# -- the metrics library --------------------------------------------------------


@pytest.mark.parametrize("name", list(j_em.METRICS_FNS))
def test_metric_matches_jax(split, name):
    """Each metric on one converted state (the JAX env after its first
    step) and the converted observations, the same weights."""
    envt, pt = split["envt"], split["pt"]
    (sj, oj, *_), _ = split["steps"][0]
    st = convert.env_state_from_numpy(
        _to_numpy_state(sj), t_env.make_generator(0, "cpu"), device="cpu")
    ot = {k: torch.from_numpy(np.array(v)) for k, v in oj.items()}
    ref = split["metrics_j"][name]
    with torch.no_grad():
        out = t_em.METRICS_FNS[name](envt, st, pt, ot)
    if name == "auxiliary_rewards":
        assert list(out) == list(envt.reward_names)
        assert set(ref) == set(out)
        for term in ref:
            assert tuple(out[term].shape) == (N,)
            assert_close(out[term], ref[term], 1e-5, 1e-6, err_msg=term)
        assert max(float(v.abs().max()) for v in out.values()) > 0
        return
    assert tuple(out.shape) == np.asarray(ref).shape
    assert_close(out, ref, 1e-5, 1e-6, err_msg=name)


@pytest.mark.parametrize("preset", list(j_em.DR_SETTINGS))
def test_dr_settings_match_jax(preset):
    assert set(t_em.DR_SETTINGS) == set(j_em.DR_SETTINGS)
    assert dataclasses.asdict(t_em.DR_SETTINGS[preset]) == \
        dataclasses.asdict(j_em.DR_SETTINGS[preset])


def test_evaluate_policy_runs(split):
    out = t_em.evaluate_policy(split["envt"], split["pt"],
                               t_env.make_generator(2, "cpu"), num_steps=2)
    assert list(out) == ["lin_vel_rmsd", "ang_vel_rmsd",
                         "power_consumption", "cost_of_transport"]
    assert all(np.isfinite(v) for v in out.values())


# -- entry points -------------------------------------------------------------


@pytest.fixture(scope="module")
def runner_run(split, tmp_path_factory):
    """A Runner with eval envs and eval_expert, one iteration of 4 steps in
    which one eval env finishes its episode; then a Runner resumed from its
    checkpoint."""
    envt = split["envt"]
    args = dict(num_steps_per_env=4, log_freq=1, save_interval=1,
                curriculum_dump_freq=10 ** 6, eval_expert=True)
    d = str(tmp_path_factory.mktemp("eval_run"))
    a = Runner(envt, log_dir=d, seed=5, args=RunnerArgs(**args))
    a.env_state, a.obs_dict = envt.reset(t_env.make_generator(6, "cpu"))
    ep = a.env_state.episode_length.clone()
    ep[T_ENVS] = envt.max_episode_length
    a.env_state = a.env_state._replace(episode_length=ep)
    a.learn(1)
    b = Runner(envt, log_dir=str(tmp_path_factory.mktemp("eval_resumed")),
               seed=5, args=RunnerArgs(resume=True, resume_path=os.path.join(
                   d, "checkpoints", "train_state_000001.pkl"), **args))
    return a, b


def test_runner_logs_the_jax_runners_eval_keys(split, runner_run, tmp_path):
    import json
    a, _ = runner_run
    assert a.train_iter is not None and a.args.eval_expert
    with_eval, _ = _jax_runner_row_keys(
        split["envt"], a.env_state.commands.shape, str(tmp_path),
        eval_count=1.0)
    eval_keys = {k for k in with_eval if k.startswith("eval/episode/")}
    assert "eval/episode/rew_total/mean" in eval_keys
    rows = [json.loads(line)
            for line in open(os.path.join(a.log_dir, "metrics.jsonl"))]
    assert len(rows) == 1 and eval_keys <= set(rows[0])
    assert all(np.isfinite(v) for v in rows[0].values())


def test_checkpoint_keeps_the_eval_curriculum(runner_run):
    a, b = runner_run
    assert b.train_state.iteration == 1
    for leaf in ("weights", "bin_task_sums", "bin_ep_counts"):
        assert torch.equal(getattr(b.env_state.curriculum_eval, leaf),
                           getattr(a.env_state.curriculum_eval, leaf))
    assert float(a.env_state.curriculum_eval.bin_ep_counts.sum()) > 0


def test_train_script_eval_flags_run_on_the_cpu(tmp_path):
    runner = t_train.train_go1(
        4, 1, str(tmp_path / "run"), 1, num_eval_envs=2, eval_expert=True,
        eval_dr="static_high", config="small", device="cpu")
    env = runner.env
    assert (env.num_train_envs, env.num_eval_envs) == (4, 2)
    assert runner.args.eval_expert and runner.train_state.iteration == 1
    fr = runner.env_state.friction_coeffs.numpy()
    assert (fr[4:] >= 4.49).all() and (fr[4:] <= 4.5).all()
    assert os.path.exists(tmp_path / "run" / "checkpoints" /
                          "policy_latest.npz")


def test_evaluate_script_on_the_cpu(runner_run, capsys):
    a, _ = runner_run
    path = os.path.join(a.log_dir, "checkpoints", "policy_latest.npz")
    out = t_evaluate.evaluate(path, ["static_medium", "static_low"], 1, 2, 0,
                              device="cpu")
    assert list(out) == ["static_medium", "static_low"]
    assert all(np.isfinite(v) for row in out.values() for v in row.values())
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["static_medium", "static_low"]
    with pytest.raises(RuntimeError, match="CUDA"):
        t_evaluate.main(["--policy", path, "--steps", "1"])
    with pytest.raises(ValueError, match="unknown"):
        t_evaluate.evaluate(path, ["bogus"], 1, 4, 0, device="cpu")
