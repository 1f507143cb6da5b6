"""RMA teacher-student training and the trajectory utilities of the port vs
the JAX package, on the CPU.

- `learn/traj_utils`: `split_and_pad_trajectories`, `unpad_trajectories`
  and `recurrent_minibatches` against the JAX functions and against
  `tests/test_traj_utils.py`'s per-env oracle, over that file's seeds,
  exactly (index arithmetic and copies only); a `max_num_trajs` below the
  true count drops the trajectories numbered past it, as the JAX scatter's
  `mode="drop"` does; `T * N` bounds the count.
- `learn/ppo_rma`: both packages' `make_train_iteration` over
  `tests/test_torch_ppo.py`'s stub env (given an `obs` key here) and its
  recording scan, N = 8 envs, 8 steps, 2 epochs x 2 minibatches, the RMA
  widths of the reference.  The JAX action noise and permutation are
  replayed into the port.  Two iterations: the first from fresh
  optimizers, the second from the JAX learner state after the first,
  carried in by `utils/convert.rma_train_state_from_numpy`.
  Tolerances: rollout and GAE rtol 1e-5 / atol 1e-5 (largest error seen
  5.7e-6 / 2.3e-6 absolute); the first minibatch's losses, KL and
  adaptation loss rtol 1e-4 (largest seen 1.1e-6 relative); the
  learning-rate sequence exactly (float32 both sides); every parameter
  after the update 2e-4 absolute (largest seen 1.3e-4: 4 Adam steps whose
  normalised updates amplify rounding in small gradients, as in
  tests/test_torch_ppo.py), the Adam moments rtol 1e-3 / atol 1e-6.
- `Runner(algo="rma", device="cpu")`: two iterations, a bit-equal resume,
  the export read back by the JAX package's numpy deploy loader.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from walk_these_ways_tpu.deploy.deploy_policy import load_student_policy
from walk_these_ways_tpu.learn import ppo as j_ppo
from walk_these_ways_tpu.learn import ppo_rma as j_rma
from walk_these_ways_tpu.learn import traj_utils as j_traj

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.deploy import deploy_policy as t_deploy
from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
from walk_these_ways_tpu_torch.learn import ppo as t_ppo
from walk_these_ways_tpu_torch.learn import ppo_rma as t_rma
from walk_these_ways_tpu_torch.learn import traj_utils as t_traj
from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs
from walk_these_ways_tpu_torch.models import actor_critic as t_ac
from walk_these_ways_tpu_torch.scripts import train as t_train
from walk_these_ways_tpu_torch.utils import convert

from test_torch_ppo import (ACT, ARGS, N, NUM_OBS, PRIV, T, Curr, StubState,
                            _recording_scan, _StubEnv)
from test_torch_util import assert_close, t
from test_traj_utils import oracle_split, random_case

torch.set_num_threads(1)


# -- traj_utils -----------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_split_and_unpad_match_jax_and_the_oracle(seed):
    x, dones = random_case(seed)
    want_p, want_m = oracle_split(x, dones)
    got_p, got_m = t_traj.split_and_pad_trajectories(t(x), t(dones))
    jp, jm = j_traj.split_and_pad_trajectories(jnp.asarray(x),
                                               jnp.asarray(dones))
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(jm))
    back = t_traj.unpad_trajectories(got_p, t(dones))
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(j_traj.unpad_trajectories(jp, jnp.asarray(
            dones))))


@pytest.mark.parametrize("bound", ["tn", "below"])
def test_split_with_a_given_bound(bound):
    """`T * N` pads the true count with empty trajectories; a bound below
    the count drops the trajectories numbered past it (the JAX scatter's
    mode="drop"), where an unmasked torch index_put_ would raise."""
    x, dones = random_case(5)
    T_, N_ = dones.shape
    want_p, want_m = oracle_split(x, dones)
    M = want_p.shape[1]
    bound_m = T_ * N_ if bound == "tn" else M - 3
    got_p, got_m = t_traj.split_and_pad_trajectories(t(x), t(dones),
                                                     max_num_trajs=bound_m)
    jp, jm = jax.jit(lambda a, d: j_traj.split_and_pad_trajectories(
        a, d, max_num_trajs=bound_m))(jnp.asarray(x), jnp.asarray(dones))
    assert tuple(got_p.shape) == (T_, bound_m) + x.shape[2:]
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(jm))
    keep = min(M, bound_m)
    np.testing.assert_array_equal(got_p[:, :keep].numpy(), want_p[:, :keep])
    np.testing.assert_array_equal(got_m[:, :keep].numpy(), want_m[:, :keep])
    assert not bool(got_m[:, keep:].any())


def test_recurrent_minibatches_match_jax_and_the_oracle():
    x, dones = random_case(6, T=8, N=6, F=2)
    acts = np.random.RandomState(7).randn(8, 6, 2).astype(np.float32)
    mine = list(t_traj.recurrent_minibatches(
        {"obs": t(x)}, {"actions": t(acts)}, t(dones), num_mini_batches=2))
    theirs = list(j_traj.recurrent_minibatches(
        {"obs": jnp.asarray(x)}, {"actions": jnp.asarray(acts)},
        jnp.asarray(dones), num_mini_batches=2))
    assert len(mine) == len(theirs) == 2
    for i, (a, b) in enumerate(zip(mine, theirs)):
        sl = slice(3 * i, 3 * i + 3)
        want_p, want_m = oracle_split(x[:, sl], dones[:, sl])
        np.testing.assert_array_equal(a["obs"].numpy(), want_p)
        np.testing.assert_array_equal(a["masks"].numpy(), want_m)
        np.testing.assert_array_equal(a["actions"].numpy(), acts[:, sl])
        for k in ("obs", "masks", "actions"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))


# -- the RMA iteration on the stub env --------------------------------------


class _ObsStubEnv(_StubEnv):
    """The stub with the current observation as an `obs` key too."""

    def obs(self, h):
        return dict(super().obs(h), obs=0.7 * h[:, PRIV:PRIV + NUM_OBS])


class _ReplayRMAPolicy(t_rma.RMAPolicy):
    """RMAPolicy whose action noise comes from a list of arrays."""
    noise = ()

    def sample_actions(self, obs, privileged_obs, generator, rows=None):
        mean, _ = self.teacher_mean(obs, privileged_obs)
        std = self.std.expand_as(mean)
        eps, self.noise = self.noise[0], self.noise[1:]
        if rows is not None:
            # the rows of a draw over the batch (ActorCritic.sample_actions)
            eps = eps[rows[1]]
        actions = mean + std * eps
        return actions, t_ac.gaussian_log_prob(actions, mean, std), mean, std


_MLPS = ("encoder", "adaptation", "actor", "critic")


def _flat_mlp(mlp, prefix):
    out = {}
    for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
        out[f"{prefix}w{i}"] = np.asarray(w)
        out[f"{prefix}b{i}"] = np.asarray(b)
    return out


def _flat_params(p):
    out = {"std": np.asarray(p.std)}
    for name in _MLPS:
        out.update(_flat_mlp(getattr(p, name), f"{name}/"))
    return out


def _adam_numpy(opt_state, flat):
    adam = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return dict(count=int(adam[0].count), mu=flat(adam[0].mu),
                nu=flat(adam[0].nu))


def _train_state_numpy(ts):
    return dict(params=_flat_params(ts.params),
                opt=_adam_numpy(ts.opt_state, _flat_params),
                adapt_opt=_adam_numpy(ts.adapt_opt_state,
                                      lambda m: _flat_mlp(m, "adaptation/")),
                lr=float(ts.lr), iteration=int(ts.iteration))


@pytest.fixture(scope="module")
def runs():
    """Two JAX RMA iterations with everything recorded, and for each the
    learner state before it plus the replayed noise and permutation."""
    args_j = j_ppo.PPO_Args(**ARGS)
    envj = _ObsStubEnv(jnp)
    ts = j_rma.init_train_state(jax.random.PRNGKey(0), envj, args_j)
    ts = ts._replace(params=ts.params._replace(std=jnp.asarray(
        np.random.RandomState(0).uniform(0.6, 1.2, ACT).astype(np.float32))))
    ts = ts._replace(opt_state=j_ppo.make_optimizers(args_j)[0].init(
        ts.params))
    s, o = envj.reset()
    out, records = [], []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", _recording_scan(records, jax.lax.scan))
    try:
        fn = jax.jit(j_rma.make_train_iteration(envj, args_j, num_steps=T))
        for _ in range(2):
            del records[:]
            before = _train_state_numpy(ts)
            _, k_roll, k_perm = jax.random.split(ts.rng, 3)
            noise, rng = [], k_roll
            for _ in range(T):
                rng, k_act = jax.random.split(rng)
                noise.append(np.asarray(jax.random.normal(k_act, (N, ACT))))
            perm = np.asarray(jax.random.permutation(k_perm, T * N))
            s0 = s
            s, o, ts, metrics = fn(s, o, ts)
            jax.effects_barrier()
            (_, (traj, logs)), (_, advs), (mb_c, mb_y) = records
            out.append(dict(before=before, after=_train_state_numpy(ts),
                            noise=noise, perm=perm, start=s0, traj=traj,
                            advs=np.asarray(advs), mb_carries=mb_c,
                            mb_metrics=[np.asarray(y) for y in mb_y],
                            metrics=metrics))
    finally:
        mp.undo()
    return out


def _port_state(run):
    return convert.rma_train_state_from_numpy(
        run["before"], torch.Generator().manual_seed(0),
        t_ppo.PPO_Args(**ARGS), device="cpu")


@pytest.mark.parametrize("it", [0, 1])
def test_rma_rollout_and_gae_match_jax(runs, it):
    run = runs[it]
    ts = _port_state(run)
    ts.policy.__class__ = _ReplayRMAPolicy
    ts.policy.noise = [t(e) for e in run["noise"]]
    envt = _ObsStubEnv(torch)
    st = run["start"]
    s = StubState(t(st.h), t(st.t), Curr(t(st.curriculum.weights)))
    s, o, traj, logs = t_rma.collect(envt, s, envt.obs(s.h), ts.policy,
                                     ts.rng, T, 0.99)
    # the JAX rollout's stacked tuple has RMATransition's order
    for name, ref in zip(t_rma.RMATransition._fields, run["traj"]):
        a, b = getattr(traj, name), np.asarray(ref)
        assert tuple(a.shape) == b.shape, name
        if b.dtype == bool:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert_close(a, b, 1e-5, 1e-5, err_msg=name)
    assert bool(traj.dones.any()) and int(logs[6].sum()) > 0
    with torch.no_grad():
        last = ts.policy.evaluate(o["obs"], o["privileged_obs"])
        returns, advs = t_ppo.compute_gae(traj, last, 0.99, 0.95)
    adv_j = run["advs"]
    assert_close(returns, adv_j + np.asarray(run["traj"][6]), 1e-5, 1e-5)
    assert_close(advs, (adv_j - adv_j.mean()) / (adv_j.std() + 1e-8),
                 1e-4, 1e-5)


def _jax_data(run):
    """The ten flattened columns of the JAX rollout, as torch tensors."""
    traj = [np.asarray(x) for x in run["traj"]]
    advs = run["advs"]
    returns = advs + traj[6]
    norm = (advs - advs.mean()) / (advs.std() + 1e-8)
    cols = (traj[0], traj[1], traj[2], traj[3], traj[7], traj[8], traj[9],
            traj[6], returns, norm)
    return tuple(t(x.reshape((-1,) + x.shape[2:])) for x in cols)


@pytest.mark.parametrize("it", [0, 1])
def test_rma_update_matches_jax(runs, it):
    run = runs[it]
    ts = _port_state(run)
    lr, ms = t_rma.update(ts.policy, (ts.optimizer, ts.adapt_optimizer),
                          ts.lr, _jax_data(run), t(run["perm"]),
                          t_ppo.PPO_Args(**ARGS))
    v_j, s_j, a_j, kl_j = run["mb_metrics"]
    for mine, theirs, name in ((ms.value_loss, v_j, "value"),
                               (ms.surrogate_loss, s_j, "surrogate"),
                               (ms.adaptation_loss, a_j, "adaptation"),
                               (ms.kl, kl_j, "kl")):
        np.testing.assert_allclose(float(mine[0]), float(theirs[0]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        assert mine.shape == (4,)
    assert torch.equal(ms.adaptation_test_loss, ms.adaptation_loss)
    lr_j = [float(x) for x in np.asarray(run["mb_carries"][3])]
    assert list(ms.lr) == lr_j
    assert lr == lr_j[-1] == run["after"]["lr"]
    after = convert.rma_train_state_to_numpy(ts)
    for key, ref in run["after"]["params"].items():
        assert_close(after["params"][key], ref, 0, 2e-4, err_msg=key)
        assert np.abs(ref - run["before"]["params"][key]).max() > 1e-5, key
    # the main Adam holds every parameter: the adaptation module's moments
    # stay zero (the PPO loss does not reach it) and its step count is the
    # others' (zero gradients, not skipped parameters)
    for opt in ("opt", "adapt_opt"):
        assert after[opt]["count"] == run["after"][opt]["count"] == 4 * (
            it + 1)
        assert set(after[opt]["mu"]) == set(run["after"][opt]["mu"])
        for m in ("mu", "nu"):
            for key, ref in run["after"][opt][m].items():
                assert_close(after[opt][m][key], ref, 1e-3, 1e-6,
                             err_msg=f"{opt} {m} {key}")
    for key in after["opt"]["mu"]:
        if key.startswith("adaptation/"):
            assert not after["opt"]["mu"][key].any(), key
    assert all(int(st["step"]) == 4 * (it + 1)
               for st in ts.optimizer.state.values())
    assert len(ts.optimizer.state) == len(list(ts.policy.parameters()))


def test_rma_train_state_round_trip(runs):
    state = runs[1]["before"]
    assert set(state["params"]) >= {"encoder/w0", "adaptation/w2",
                                    "actor/w3", "critic/b3", "std"}
    ts = _port_state(runs[1])
    assert isinstance(ts, t_rma.RMATrainState)
    assert ts.policy.encoder.weights[-1].shape[1] == 18
    back = convert.rma_train_state_to_numpy(ts)
    assert back["lr"] == state["lr"] and back["iteration"] == 1
    for part in ("opt", "adapt_opt"):
        assert back[part]["count"] == state[part]["count"] == 4
        for m in ("mu", "nu"):
            assert set(back[part][m]) == set(state[part][m])
            for key, ref in state[part][m].items():
                np.testing.assert_array_equal(back[part][m][key], ref)
    for key, ref in state["params"].items():
        np.testing.assert_array_equal(back["params"][key], ref)


def test_rma_iteration_on_the_stub_and_its_eval_slice():
    """The port's own iteration: finite metrics, the state advanced, the
    same generator reproducing the same update; with eval envs the eval
    slice acts with `student_mean` (`teacher_mean` with eval_expert)."""
    args = t_ppo.PPO_Args(**ARGS)
    envt = _ObsStubEnv(torch)
    outs = []
    for _ in range(2):
        ts = t_rma.init_train_state(7, envt, args)
        s, o = envt.reset()
        s, o, ts2, m = t_rma.make_train_iteration(envt, args, num_steps=T)(
            s, o, ts)
        assert ts2.iteration == 1 and int(s.t) == T
        assert 1e-5 <= m.lr <= 1e-2
        for name in ("value_loss", "surrogate_loss", "adaptation_loss",
                     "mean_kl", "mean_reward"):
            assert bool(torch.isfinite(getattr(m, name))), name
        assert m.adaptation_test_loss == m.adaptation_loss
        outs.append(ts2.policy.actor.weights[0].detach().clone())
    assert torch.equal(outs[0], outs[1])

    class Split(_ObsStubEnv):
        num_train_envs, num_eval_envs = N - 2, 2

        def step(self, s, actions):
            self.given.append(actions.clone())
            return super().step(s, actions)

    for expert in (False, True):
        env = Split(torch)
        env.given = []
        ts = t_rma.init_train_state(7, env, args)
        s, o = env.reset()
        with torch.no_grad():
            ob, pv, h = (o[k][N - 2:] for k in ("obs", "privileged_obs",
                                                "obs_history"))
            want = (ts.policy.teacher_mean(ob, pv)[0] if expert
                    else ts.policy.student_mean(ob, h))
        fn = t_rma.make_train_iteration(env, args, num_steps=3,
                                        eval_expert=expert)
        _, _, ts2, m = fn(s, o, ts)
        assert torch.equal(env.given[0][N - 2:], want)
        assert ts2.iteration == 1 and bool(torch.isfinite(m.value_loss))


# -- the runner and the training script --------------------------------------


@pytest.fixture(scope="module")
def rma_runs(tmp_path_factory):
    env = LeggedRobotEnv(t_cfg.small_train_cfg(8), device="cpu")
    kw = dict(num_steps_per_env=2, log_freq=1, save_interval=1,
              curriculum_dump_freq=10 ** 6)
    d_a = str(tmp_path_factory.mktemp("rma_a"))
    a = Runner(env, log_dir=d_a, seed=3, args=RunnerArgs(**kw), algo="rma")
    a.learn(2)
    b = Runner(env, log_dir=str(tmp_path_factory.mktemp("rma_b")), seed=3,
               args=RunnerArgs(resume=True, resume_path=os.path.join(
                   d_a, "checkpoints", "train_state_000001.pkl"), **kw),
               algo="rma")
    assert b.train_state.iteration == 1
    b.learn(1)
    return env, a, b


def test_rma_runner_resumes_bit_equal(rma_runs):
    _, a, b = rma_runs
    assert isinstance(a.train_state, t_rma.RMATrainState)
    assert a.train_state.iteration == b.train_state.iteration == 2
    assert a.train_state.lr == b.train_state.lr
    for p, q in zip(a.train_state.policy.parameters(),
                    b.train_state.policy.parameters()):
        assert torch.equal(p, q)
    ta, tb = (convert.rma_train_state_to_numpy(r.train_state) for r in (a, b))
    for opt in ("opt", "adapt_opt"):
        assert ta[opt]["count"] == tb[opt]["count"] == 2 * 4 * 5
        for k in ta[opt]["nu"]:
            np.testing.assert_array_equal(ta[opt]["nu"][k], tb[opt]["nu"][k])
    for k in a.obs_dict:
        assert torch.equal(a.obs_dict[k], b.obs_dict[k])


def test_rma_export_is_read_by_the_jax_deploy_loader(rma_runs):
    env, a, _ = rma_runs
    path = os.path.join(a.log_dir, "checkpoints", "policy_latest.npz")
    z = np.load(path)
    assert str(z["meta/variant"]) == "rma"
    assert int(z["meta/n_adaptation"]) == 3 and int(z["meta/n_actor"]) == 4
    assert "encoder/w0" not in z.files
    rs = np.random.RandomState(0)
    obs = rs.randn(1, env.num_obs).astype(np.float32)
    hist = rs.randn(1, env.num_obs_history).astype(np.float32)
    action = load_student_policy(path)({"obs": obs, "obs_history": hist})
    with torch.no_grad():
        want = a.train_state.policy.student_mean(t(obs), t(hist))[0]
    assert_close(want, action, 1e-5, 1e-5)


def test_rma_export_is_read_by_the_port_deploy_loader(rma_runs):
    """The port's own numpy loader on the same export: the JAX loader's
    bits, and the student's actions."""
    env, a, _ = rma_runs
    path = os.path.join(a.log_dir, "checkpoints", "policy_latest.npz")
    rs = np.random.RandomState(1)
    obs = rs.randn(1, env.num_obs).astype(np.float32)
    hist = rs.randn(1, env.num_obs_history).astype(np.float32)
    inputs = {"obs": obs, "obs_history": hist}
    action = t_deploy.load_student_policy(path)(inputs)
    np.testing.assert_array_equal(action, load_student_policy(path)(inputs))
    with torch.no_grad():
        want = a.train_state.policy.student_mean(t(obs), t(hist))[0]
    assert_close(want, action, 1e-5, 1e-5)


def test_train_script_algo_rma_builds_and_needs_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--num-envs", "4", "--iterations", "1", "--algo",
                      "rma", "--log-dir", str(tmp_path)])
