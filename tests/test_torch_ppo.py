"""The PPO iteration of the port vs the JAX package, on the CPU.

Both packages' `make_train_iteration` are driven over a stub env written
twice (a small deterministic recurrence, numpy matrices shared), N = 8 envs,
8 steps, 2 epochs x 2 minibatches, narrow observation widths.  The JAX
iteration runs jitted with `jax.lax.scan` wrapped, inside this module only,
so that every step's carry and output also reach the host: that exposes the
stacked rollout, the advantages, and every minibatch's losses, KL and
learning rate.  The action noise and the permutation are replayed from the
JAX key splits (learn/ppo.py:289,143) and handed to the port as arrays.

Two iterations are compared: the first from fresh optimizers, the second
from the JAX learner state after the first (nonzero Adam moments and step
counts) carried into the port by `utils/convert.train_state_from_numpy`.

Tolerances: rollout and GAE rtol 1e-5 / atol 1e-5 (same float32 operations,
other summation order); the first minibatch's losses and KL rtol 1e-4; the
learning-rate sequence exactly (float32 on both sides); every parameter
after the whole update 2e-4 absolute (4 Adam steps whose normalised updates
amplify rounding differences in small gradients).
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from walk_these_ways_tpu.learn import ppo as j_ppo
from walk_these_ways_tpu.models import actor_critic as j_ac

from walk_these_ways_tpu_torch.learn import ppo as t_ppo
from walk_these_ways_tpu_torch.models import actor_critic as t_ac
from walk_these_ways_tpu_torch.utils import convert

from test_ppo import _ref_gae
from test_torch_util import assert_close, t

torch.set_num_threads(1)
N, T = 8, 8
NUM_OBS, HIST, PRIV, ACT = 4, 40, 2, 12
ARGS = dict(num_learning_epochs=2, num_mini_batches=2)
_rs = np.random.RandomState(3)
A_MAT = (0.3 * _rs.randn(HIST, HIST)).astype(np.float32)
B_MAT = (0.2 * _rs.randn(ACT, HIST)).astype(np.float32)
H0 = _rs.randn(N, HIST).astype(np.float32)
ENV_IDX = np.arange(N)

Info = collections.namedtuple("Info", [
    "time_outs", "ep_sums_done", "ep_count_done", "ep_len_done",
    "eval_ep_sums_done", "eval_ep_count_done", "eval_ep_len_done",
    "envelope_exits"])
Curr = collections.namedtuple("Curr", ["weights"])
StubState = collections.namedtuple("StubState", ["h", "t", "curriculum"])


class _StubEnv:
    """h' = tanh(h A + a B); reward, done and time-out are simple functions
    of (h, a, t).  `xp` is jnp or torch."""
    num_train_envs = N
    num_eval_envs = 0
    num_obs, num_obs_history = NUM_OBS, HIST
    num_privileged_obs, num_actions = PRIV, ACT
    device = torch.device("cpu")

    def __init__(self, xp):
        self.xp = xp
        self.arr = jnp.asarray if xp is jnp else torch.from_numpy
        self.A, self.B = self.arr(A_MAT), self.arr(B_MAT)
        self.idx = self.arr(ENV_IDX)

    def obs(self, h):
        return {"obs_history": h, "privileged_obs": 0.5 * h[:, :PRIV]}

    def reset(self):
        w = self.arr(np.full((3, 5), 0.25, np.float32))
        s = StubState(self.arr(H0), self.arr(np.zeros((), np.int32)), Curr(w))
        return s, self.obs(s.h)

    def step(self, s, actions):
        xp = self.xp
        h = xp.tanh(s.h @ self.A + actions @ self.B)
        t1 = s.t + 1
        rew = h[:, 0] - 0.05 * xp.mean(xp.square(actions), -1)
        done = ((t1 + self.idx) % 5) == 0
        time_out = done & (((t1 + self.idx) % 2) == 0)
        f = (lambda x: x.astype(jnp.float32)) if xp is jnp else \
            (lambda x: x.to(torch.float32))
        info = Info(
            time_outs=time_out,
            ep_sums_done=xp.sum(f(done))[None] * self.arr(
                np.ones(3, np.float32)),
            ep_count_done=xp.sum(done), ep_len_done=xp.sum(done) * 5,
            eval_ep_sums_done=self.arr(np.zeros(3, np.float32)),
            eval_ep_count_done=self.arr(np.zeros((), np.int32)),
            eval_ep_len_done=self.arr(np.zeros((), np.int32)),
            envelope_exits=xp.sum(f(time_out)))
        s = StubState(h, t1, s.curriculum)
        return s, self.obs(h), rew, done, info


class _ReplayPolicy(t_ac.ActorCritic):
    """ActorCritic whose action noise comes from a list of arrays."""
    noise = ()

    def sample_actions(self, obs_history, generator, rows=None):
        mean = self.actor_mean(obs_history)
        std = self.std.expand_as(mean)
        eps, self.noise = self.noise[0], self.noise[1:]
        if rows is not None:
            # the rows of a draw over the batch (ActorCritic.sample_actions)
            eps = eps[rows[1]]
        actions = mean + std * eps
        return actions, t_ac.gaussian_log_prob(actions, mean, std), mean, std


def _flatten_params(p):
    out = {"std": np.asarray(p.std)}
    for name in ("adaptation", "actor", "critic"):
        mlp = getattr(p, name)
        for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
            out[f"{name}/w{i}"] = np.asarray(w)
            out[f"{name}/b{i}"] = np.asarray(b)
    return out


def _adam_numpy(opt_state, prefix=""):
    """count / mu / nu of the one ScaleByAdamState inside an optax state."""
    adam = [x for x in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(x, optax.ScaleByAdamState)]
    assert len(adam) == 1
    adam = adam[0]

    def flat(tree):
        if isinstance(tree, j_ac.ACParams):
            return _flatten_params(tree)
        out = {}
        for i, (w, b) in enumerate(zip(tree.weights, tree.biases)):
            out[f"{prefix}w{i}"] = np.asarray(w)
            out[f"{prefix}b{i}"] = np.asarray(b)
        return out
    return dict(count=int(adam.count), mu=flat(adam.mu), nu=flat(adam.nu))


def _train_state_numpy(ts):
    return dict(params=_flatten_params(ts.params),
                opt=_adam_numpy(ts.opt_state),
                adapt_opt=_adam_numpy(ts.adapt_opt_state, "adaptation/"),
                lr=float(ts.lr), iteration=int(ts.iteration))


def _recording_scan(records, real_scan):
    """`jax.lax.scan` that also hands every step's carry and output to the
    host (a debug callback, so it works under jit)."""
    def scan(f, init, xs, length=None, reverse=False):
        def body(carry, x):
            carry, y = f(carry, x)
            return carry, (y, carry)
        carry, (ys, carries) = real_scan(body, init, xs, length=length,
                                         reverse=reverse)
        jax.debug.callback(lambda c, y: records.append((c, y)), carries, ys,
                           ordered=True)
        return carry, ys
    return scan


@pytest.fixture(scope="module")
def runs():
    """Two JAX iterations with everything recorded, and for each the port's
    learner state before it plus the replayed noise and permutation."""
    args_j = j_ppo.PPO_Args(**ARGS)
    envj = _StubEnv(jnp)
    ts = j_ppo.init_train_state(jax.random.PRNGKey(0), envj, args_j)
    ts = ts._replace(params=ts.params._replace(std=jnp.asarray(
        np.random.RandomState(0).uniform(0.6, 1.2, ACT).astype(np.float32))))
    ts = ts._replace(opt_state=j_ppo.make_optimizers(args_j)[0].init(ts.params))
    s, o = envj.reset()
    out = []
    records = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.lax, "scan", _recording_scan(records, jax.lax.scan))
    try:
        fn = jax.jit(j_ppo.make_train_iteration(envj, args_j, num_steps=T))
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
            (roll_c, (traj, logs)), (_, advs), (mb_c, mb_y) = records
            out.append(dict(before=before, after=_train_state_numpy(ts),
                            noise=noise, perm=perm, start=s0, traj=traj,
                            advs=np.asarray(advs), mb_carries=mb_c,
                            mb_metrics=[np.asarray(y) for y in mb_y],
                            metrics=metrics))
    finally:
        mp.undo()
    return out


def _port_state(run):
    return convert.train_state_from_numpy(
        run["before"], torch.Generator().manual_seed(0),
        t_ppo.PPO_Args(**ARGS), device="cpu")


def _torch_start(run):
    envt = _StubEnv(torch)
    s = StubState(t(run["start"].h), t(run["start"].t),
                  Curr(t(run["start"].curriculum.weights)))
    return envt, s, envt.obs(s.h)


def _jax_data(run):
    """The nine flattened columns of the JAX rollout, as torch tensors."""
    traj = run["traj"]
    returns = run["advs"] + np.asarray(traj.values)
    advs = run["advs"]
    norm = (advs - advs.mean()) / (advs.std() + 1e-8)

    def flat(x):
        x = np.asarray(x)
        return t(x.reshape((-1,) + x.shape[2:]))
    return tuple(flat(x) for x in (
        traj.obs_history, traj.privileged_obs, traj.actions, traj.log_probs,
        traj.mu, traj.sigma, traj.values, returns, norm))


@pytest.mark.parametrize("it", [0, 1])
def test_collect_matches_jax_rollout(runs, it):
    run = runs[it]
    ts = _port_state(run)
    ts.policy.__class__ = _ReplayPolicy
    ts.policy.noise = [t(e) for e in run["noise"]]
    envt, s, o = _torch_start(run)
    s, o, traj, logs = t_ppo.collect(envt, s, o, ts.policy, ts.rng, T, 0.99)
    for name in t_ppo.Transition._fields:
        a, b = getattr(traj, name), np.asarray(getattr(run["traj"], name))
        assert tuple(a.shape) == b.shape, name
        if b.dtype == bool:
            np.testing.assert_array_equal(a.numpy(), b)
        else:
            assert_close(a, b, 1e-5, 1e-5, err_msg=name)
    assert bool(traj.dones.any()) and int(logs[6].sum()) > 0
    # the time-out bootstrap went in: rewards differ from the env's own
    assert float(logs[1].sum()) == float(np.asarray(run["metrics"].ep_count_done))


@pytest.mark.parametrize("it", [0, 1])
def test_compute_gae_matches_jax_scan_and_numpy_oracle(runs, it):
    run = runs[it]
    tj = run["traj"]
    traj = t_ppo.Transition(*[t(np.asarray(getattr(tj, n)))
                              for n in t_ppo.Transition._fields])
    mb_params = run["before"]["params"]
    policy = convert.actor_critic_from_numpy(mb_params, device="cpu")
    # last values: the critic on the observation after the last step
    h_last = np.tanh(np.asarray(tj.obs_history[-1]) @ A_MAT
                     + np.asarray(tj.actions[-1]) @ B_MAT)
    with torch.no_grad():
        last = policy.evaluate(t(h_last), 0.5 * t(h_last)[:, :PRIV])
        returns, advs = t_ppo.compute_gae(traj, last, 0.99, 0.95)
    adv_j = run["advs"]
    assert_close(returns, adv_j + np.asarray(tj.values), 1e-5, 1e-5)
    assert_close(advs, (adv_j - adv_j.mean()) / (adv_j.std() + 1e-8),
                 1e-4, 1e-5)
    ret_ref, adv_ref = _ref_gae(
        np.asarray(tj.rewards), np.asarray(tj.dones).astype(np.float32),
        np.asarray(tj.values), last.numpy(), 0.99, 0.95)
    assert_close(returns, ret_ref, 1e-5, 1e-5)
    assert_close(advs, adv_ref, 1e-4, 1e-5)


@pytest.mark.parametrize("it", [0, 1])
def test_update_matches_jax(runs, it):
    run = runs[it]
    ts = _port_state(run)
    lr, ms = t_ppo.update(ts.policy, (ts.optimizer, ts.adapt_optimizer),
                          ts.lr, _jax_data(run), t(run["perm"]),
                          t_ppo.PPO_Args(**ARGS))
    v_j, s_j, a_j, at_j, kl_j = run["mb_metrics"]
    # first minibatch: surrogate, value, adaptation losses and mean KL
    for mine, theirs, name in ((ms.value_loss, v_j, "value"),
                               (ms.surrogate_loss, s_j, "surrogate"),
                               (ms.adaptation_loss, a_j, "adaptation"),
                               (ms.adaptation_test_loss, at_j, "adapt test"),
                               (ms.kl, kl_j, "kl")):
        np.testing.assert_allclose(float(mine[0]), float(theirs[0]),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
        assert mine.shape == (4,)
    # the learning-rate sequence, exactly
    lr_j = [float(x) for x in np.asarray(run["mb_carries"][3])]
    assert list(ms.lr) == lr_j
    assert lr == lr_j[-1] == run["after"]["lr"]
    assert len(set(lr_j + [run["before"]["lr"]])) > 1      # the rule fired
    # every parameter after the whole update
    after = convert.train_state_to_numpy(ts)
    worst = 0.0
    for key, ref in run["after"]["params"].items():
        assert_close(after["params"][key], ref, 0, 2e-4, err_msg=key)
        worst = max(worst, float(np.abs(after["params"][key] - ref).max()))
        moved = np.abs(ref - run["before"]["params"][key]).max()
        assert moved > 1e-5, key
    # and the optimizers' moments and step counts
    for opt in ("opt", "adapt_opt"):
        assert after[opt]["count"] == run["after"][opt]["count"]
        for key, ref in run["after"][opt]["mu"].items():
            assert_close(after[opt]["mu"][key], ref, 1e-3, 1e-6, err_msg=key)


def test_train_state_round_trip(runs):
    state = runs[1]["before"]
    assert state["opt"]["count"] == 4 and state["adapt_opt"]["count"] == 4
    ts = _port_state(runs[1])
    back = convert.train_state_to_numpy(ts)
    assert back["lr"] == state["lr"] and back["iteration"] == 1
    for part in ("opt", "adapt_opt"):
        assert back[part]["count"] == state[part]["count"]
        for m in ("mu", "nu"):
            assert set(back[part][m]) == set(state[part][m])
            for key, ref in state[part][m].items():
                np.testing.assert_array_equal(back[part][m][key], ref)
    assert set(back["adapt_opt"]["mu"]) == {
        f"adaptation/{k}{i}" for k in "wb" for i in range(3)}
    for key, ref in state["params"].items():
        np.testing.assert_array_equal(back["params"][key], ref)


def test_train_iteration_composes_the_three_parts(runs):
    """The port's own iteration on the stub env: finite metrics, the state
    advanced, the same generator reproducing the same update."""
    args = t_ppo.PPO_Args(**ARGS)
    envt = _StubEnv(torch)
    outs = []
    for _ in range(2):
        ts = t_ppo.init_train_state(7, envt, args)
        fn = t_ppo.make_train_iteration(envt, args, num_steps=T)
        s, o = envt.reset()
        w0 = ts.policy.actor.weights[0].detach().clone()
        s, o, ts2, m = fn(s, o, ts)
        assert ts2.iteration == 1 and int(s.t) == T
        assert 1e-5 <= m.lr <= 1e-2
        for name in ("value_loss", "surrogate_loss", "adaptation_loss",
                     "adaptation_test_loss", "mean_kl", "mean_reward"):
            assert bool(torch.isfinite(getattr(m, name))), name
        assert tuple(m.curriculum_area.shape) == (3,)
        assert not torch.equal(ts2.policy.actor.weights[0], w0)
        outs.append(ts2.policy.actor.weights[0].detach().clone())
    assert torch.equal(outs[0], outs[1])


class _SplitStubEnv(_StubEnv):
    """The stub with its last 2 envs an eval slice, recording the actions
    each step is given."""
    num_train_envs, num_eval_envs = N - 2, 2

    def step(self, s, actions):
        self.given.append(actions.clone())
        return super().step(s, actions)


@pytest.mark.parametrize("eval_expert", [False, True])
def test_collect_with_eval_envs_on_the_stub(eval_expert):
    """The eval envs act with the student's mean (the teacher with
    eval_expert) and draw no noise; the trajectory, the values and the
    iteration's update cover the train envs only."""
    args = t_ppo.PPO_Args(**ARGS)
    envt = _SplitStubEnv(torch)
    envt.given = []
    Tr = envt.num_train_envs
    ts = t_ppo.init_train_state(7, envt, args)
    s, o = envt.reset()
    gen = t_env_generator(5)
    s2, o2, traj, logs = t_ppo.collect(envt, s, o, ts.policy, gen, 3, 0.99,
                                       eval_expert)
    assert tuple(traj.actions.shape) == (3, Tr, ACT)
    assert tuple(traj.obs_history.shape) == (3, Tr, HIST)
    with torch.no_grad():
        hist, priv = o["obs_history"][Tr:], o["privileged_obs"][Tr:]
        want = (ts.policy.act_teacher(hist, priv) if eval_expert
                else ts.policy.actor_mean(hist))
    assert torch.equal(envt.given[0][Tr:], want)
    assert torch.equal(envt.given[0][:Tr], traj.actions[0])
    # the same draws as a rollout of the train envs alone
    gen2 = t_env_generator(5)
    a0, *_ = ts.policy.sample_actions(o["obs_history"][:Tr], gen2)
    assert torch.equal(a0, traj.actions[0])
    fn = t_ppo.make_train_iteration(envt, args, num_steps=T,
                                    eval_expert=eval_expert)
    s3, o3, ts2, m = fn(s, o, ts)
    assert ts2.iteration == 1 and bool(torch.isfinite(m.value_loss))


def test_collect_without_eval_envs_keeps_the_generator_stream():
    """With no eval envs, `collect` makes the draws and the trajectory of
    the loop it had before the split: the whole batch samples, evaluates
    and steps."""
    envt = _StubEnv(torch)
    ts = t_ppo.init_train_state(7, envt, t_ppo.PPO_Args(**ARGS))
    s, o = envt.reset()
    g_new, g_old = t_env_generator(5), t_env_generator(5)
    _, _, traj, _ = t_ppo.collect(envt, s, o, ts.policy, g_new, 3, 0.99)
    rows = []
    with torch.no_grad():
        for _ in range(3):
            hist, priv = o["obs_history"], o["privileged_obs"]
            actions, logp, mu, sigma = ts.policy.sample_actions(hist, g_old)
            values = ts.policy.evaluate(hist, priv)
            s, o, rew, done, info = envt.step(s, actions)
            rew = rew + 0.99 * values * info.time_outs.to(rew.dtype)
            rows.append((actions, logp, values, rew, done))
    for k, (actions, logp, values, rew, done) in enumerate(rows):
        assert torch.equal(traj.actions[k], actions)
        assert torch.equal(traj.log_probs[k], logp)
        assert torch.equal(traj.values[k], values)
        assert torch.equal(traj.rewards[k], rew)
        assert torch.equal(traj.dones[k], done)
    assert torch.equal(g_new.get_state(), g_old.get_state())


def t_env_generator(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g
