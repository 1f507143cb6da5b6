"""The port's training entry point on the CPU: `learn/runner.Runner` on
`small_train_cfg(8)` (P control, so K4c's plain version), 4 steps per
iteration, a log row, a checkpoint and a curriculum dump every iteration.

- the run directory holds the JAX runner's artifacts under the same names;
- every metrics.jsonl row has the key set the JAX runner writes
  (walk_these_ways_tpu/learn/runner.py:144-195);
- a new Runner resumed from the checkpoint of iteration 1 and run for one
  iteration is bit-equal to the uninterrupted run after iteration 2;
- `export_policy` writes the JAX runner's `policy_latest.npz` key by key:
  the JAX `Runner.export_policy`, called on a stand-in holding a JAX
  parameter tree made from the same weights, gives equal arrays;
- the script and the bench raise without a CUDA device; `--mesh` and
  `--multihost` build their mesh and `--shared-ckpt` its shared directory
  and reach the device check, as the eval flags build their configs
  (`--algo rma`, RMA and the videos: tests/test_torch_rma.py and
  tests/test_torch_tools.py; the mesh and shared checkpoints at work:
  tests/test_torch_parallel.py);
- `Runner.save` on a directory writes a shared checkpoint that loads back
  bit-equal;
- `scripts.play` plays back the policy the runner exported (its actions are
  the runner's policy mean) and `scripts.test` steps a few envs, both with
  device="cpu"; without it, neither runs on a box with no CUDA device.
"""
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu.envs import curriculum as j_curr
from walk_these_ways_tpu.learn import ppo as j_ppo
from walk_these_ways_tpu.learn import runner as j_runner
from walk_these_ways_tpu.models import actor_critic as j_ac
from walk_these_ways_tpu.utils import metrics_logger as j_logger

from walk_these_ways_tpu_torch import bench as t_bench
from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs
from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod
from walk_these_ways_tpu_torch.scripts import play as t_play
from walk_these_ways_tpu_torch.scripts import test as t_test
from walk_these_ways_tpu_torch.scripts import train as t_train
from walk_these_ways_tpu_torch.utils import checkpoint as t_ckpt
from walk_these_ways_tpu_torch.utils import convert, profiling

torch.set_num_threads(1)
N = 8
ARGS = dict(num_steps_per_env=4, log_freq=1, save_interval=1,
            curriculum_dump_freq=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    env = LeggedRobotEnv(t_cfg.small_train_cfg(N), device="cpu")
    d_a = str(tmp_path_factory.mktemp("run_a"))
    a = Runner(env, log_dir=d_a, seed=3, args=RunnerArgs(**ARGS))
    a.learn(2)
    d_b = str(tmp_path_factory.mktemp("run_b"))
    b = Runner(env, log_dir=d_b, seed=3, args=RunnerArgs(
        resume=True, resume_path=os.path.join(
            d_a, "checkpoints", "train_state_000001.pkl"), **ARGS))
    assert b.train_state.iteration == 1
    b.learn(1)
    return env, a, b


def test_runner_writes_the_jax_runners_artifacts(runs):
    env, a, _ = runs
    d = a.log_dir
    for name in ("metrics.jsonl", ".charts.yml", "provenance.json",
                 "checkpoints/train_state_000001.pkl",
                 "checkpoints/train_state_000002.pkl",
                 "checkpoints/train_state_last.pkl",
                 "checkpoints/policy_latest.npz",
                 "curriculum/distribution_000001.npz",
                 "curriculum/distribution_000002.npz"):
        assert os.path.exists(os.path.join(d, name)), name
    prov = json.load(open(os.path.join(d, "provenance.json")))
    assert prov["device"] == "cpu" and prov["num_envs"] == N
    assert "cuda" in prov and "torch" in prov
    cur = np.load(os.path.join(d, "curriculum/distribution_000002.npz"))
    np.testing.assert_array_equal(cur["weights"],
                                  a.env_state.curriculum.weights.numpy())
    # the checkpoint is numpy only, generator states included
    tree = t_ckpt.load(os.path.join(d, "checkpoints/train_state_last.pkl"))

    def leaves(x):
        if isinstance(x, dict):
            for v in x.values():
                yield from leaves(v)
        else:
            yield x
    assert all(v is None or isinstance(v, (np.ndarray, np.generic, int,
                                           float)) for v in leaves(tree))
    assert tree["env_state"]["rng"].dtype == np.uint8
    assert tree["train_state"]["rng"].dtype == np.uint8


def _jax_runner_row_keys(env, commands_shape, log_dir, eval_count=0.0):
    """The key sets of the rows that the JAX `Runner.learn` writes, one
    iteration with finished episodes and one without: `learn` is run on a
    stand-in whose iteration returns fixed metrics (with `eval_count`
    finished eval episodes in the first)."""
    terms = len(env.reward_names) + 1
    z = np.float32(0.0)

    def metrics(ep_count):
        return j_ppo.IterMetrics(
            value_loss=z, surrogate_loss=z, adaptation_loss=z,
            adaptation_test_loss=z, mean_kl=z, lr=z, mean_reward=z,
            ep_sums_done=np.zeros(terms, np.float32),
            ep_count_done=np.float32(ep_count), ep_len_done=z,
            eval_ep_sums_done=np.zeros(terms, np.float32),
            eval_ep_count_done=np.float32(eval_count if ep_count else 0.0),
            eval_ep_len_done=z,
            curriculum_area=np.zeros(len(j_curr.CATEGORY_NAMES), np.float32),
            envelope_exits=z)

    counts = iter((1.0, 0.0))
    state = types.SimpleNamespace(
        commands=np.zeros(tuple(commands_shape), np.float32),
        actions=np.zeros((env.num_envs, env.num_actions), np.float32))
    stand_in = types.SimpleNamespace(
        env=types.SimpleNamespace(
            reward_names=env.reward_names, num_envs=env.num_envs,
            num_train_envs=env.num_envs,
            reset=lambda key, random_episode_lengths: (state, {})),
        args=j_runner.RunnerArgs(num_steps_per_env=4, log_freq=1,
                                 save_interval=10 ** 6,
                                 curriculum_dump_freq=10 ** 6),
        train_state=types.SimpleNamespace(iteration=0), env_state=None,
        obs_dict=None, tot_timesteps=0, mesh=None, _reset_key=None,
        log_dir=log_dir,
        logger=j_logger.MetricsLogger(log_dir),
        train_iter=lambda s, o, t: (s, o, t, metrics(next(counts))),
        save=lambda path: None, export_policy=lambda path: None)
    j_runner.Runner.learn(stand_in, 2)
    rows = [json.loads(line)
            for line in open(os.path.join(log_dir, "metrics.jsonl"))]
    return [set(r) for r in rows]


def test_metrics_rows_have_the_jax_runners_keys(runs, tmp_path):
    env, a, _ = runs
    with_episodes, without = _jax_runner_row_keys(
        env, a.env_state.commands.shape, str(tmp_path))
    assert "train/episode/rew_total/mean" in with_episodes - without
    rows = [json.loads(line)
            for line in open(os.path.join(a.log_dir, "metrics.jsonl"))]
    assert [r["iterations"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) in (with_episodes, without), set(r) ^ with_episodes
        assert all(np.isfinite(v) for v in r.values())


def test_resume_is_bit_equal_to_an_uninterrupted_run(runs):
    _, a, b = runs
    assert a.train_state.iteration == b.train_state.iteration == 2
    assert a.train_state.lr == b.train_state.lr
    for p, q in zip(a.train_state.policy.parameters(),
                    b.train_state.policy.parameters()):
        assert torch.equal(p, q)
    ta = convert.train_state_to_numpy(a.train_state)
    tb = convert.train_state_to_numpy(b.train_state)
    for opt in ("opt", "adapt_opt"):
        assert ta[opt]["count"] == tb[opt]["count"]
        for m in ("mu", "nu"):
            for k in ta[opt][m]:
                np.testing.assert_array_equal(ta[opt][m][k], tb[opt][m][k])
    assert torch.equal(a.train_state.rng.get_state(),
                       b.train_state.rng.get_state())
    ea, eb = (convert.env_state_to_numpy(r.env_state) for r in (a, b))
    for name, x in ea.items():
        if isinstance(x, dict):
            for k in x:
                np.testing.assert_array_equal(x[k], eb[name][k])
        elif x is not None:
            np.testing.assert_array_equal(x, eb[name], err_msg=name)
    for k in a.obs_dict:
        assert torch.equal(a.obs_dict[k], b.obs_dict[k])


def test_export_policy_equals_the_jax_export(runs, tmp_path):
    _, a, _ = runs
    params = convert.train_state_to_numpy(a.train_state)["params"]

    def mlp(name):
        n = len([k for k in params if k.startswith(f"{name}/w")])
        return j_ac.MLPParams(
            weights=tuple(jnp.asarray(params[f"{name}/w{i}"])
                          for i in range(n)),
            biases=tuple(jnp.asarray(params[f"{name}/b{i}"])
                         for i in range(n)))

    jp = j_ac.ACParams(adaptation=mlp("adaptation"), actor=mlp("actor"),
                       critic=mlp("critic"), std=jnp.asarray(params["std"]))
    stand_in = types.SimpleNamespace(
        train_state=types.SimpleNamespace(params=jp), algo="cse")
    j_runner.Runner.export_policy(stand_in, str(tmp_path / "jax"))
    a.export_policy(str(tmp_path / "port"))
    fj = np.load(tmp_path / "jax" / "policy_latest.npz")
    ft = np.load(tmp_path / "port" / "policy_latest.npz")
    assert sorted(fj.files) == sorted(ft.files)
    for k in fj.files:
        assert fj[k].dtype == ft[k].dtype, k
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
    assert str(ft["meta/variant"]) == "cse"


def test_restore_like_refuses_a_mismatched_checkpoint(runs, tmp_path):
    _, a, _ = runs
    tree = a._state_tree()
    bad = dict(tree, obs_dict={k: v[:1] for k, v in tree["obs_dict"].items()})
    with pytest.raises(ValueError):
        t_ckpt.restore_like(tree, bad)
    with pytest.raises(ValueError):
        t_ckpt.restore_like(tree, dict(tree, extra={"x": np.zeros(1)}))
    with pytest.raises(TypeError):
        t_ckpt.save(str(tmp_path / "g.pkl"), {"g": torch.Generator()})
    # a directory path is a shared-storage checkpoint: it loads back equal
    a.save(str(tmp_path / "shared_dir"))
    back = t_ckpt.load_shared(str(tmp_path / "shared_dir"), tree, a.rows)
    for key, want in t_ckpt._keyed_leaves(tree).items():
        got = t_ckpt._keyed_leaves(back)[key]
        assert (got is None and want is None) or (
            np.asarray(got).tobytes() == np.asarray(want).tobytes()), key
    with pytest.raises(ValueError, match="remote"):
        a.save("gs://bucket/run")


@pytest.mark.parametrize("flags,item", [
    (["--mesh"], "22"), (["--multihost"], "22"),
    (["--shared-ckpt", "d"], "22")])
def test_train_script_flags_of_later_slices_raise(flags, item, monkeypatch):
    """The flags of ROADMAP item 22 (now ported): `--mesh` and
    `--multihost` build the env mesh, which needs a CUDA device unless the
    CPU is asked for, and `--shared-ckpt` resolves its shared directory
    before the device check.  No flag raises naming its item any more."""
    resolved = []
    real = t_ckpt._shared_path
    monkeypatch.setattr(t_ckpt, "_shared_path",
                        lambda p: resolved.append(p) or real(p))
    with pytest.raises(RuntimeError, match="CUDA") as e:
        t_train.main(["--num-envs", "4", "--iterations", "1"] + flags)
    assert f"item {item}" not in str(e.value)
    raised_in = os.path.join(*str(e.traceback[-1].path).split(os.sep)[-2:])
    if "--shared-ckpt" in flags:
        assert resolved == ["d"] and raised_in == os.path.join(
            "scripts", "train.py")
    else:
        assert raised_in == os.path.join("parallel", "mesh.py")


@pytest.mark.parametrize("flags", [
    ["--num-eval-envs", "4"],
    ["--num-eval-envs", "4", "--eval-expert"],
    ["--num-eval-envs", "4", "--eval-dr", "rand_large"],
    ["--num-eval-envs", "4", "--eval-terrain", "rough", "--exact"],
    ["--num-eval-envs", "4", "--eval-dr", "static_low", "--eval-terrain",
     "flat", "--terrain", "rough"]])
def test_train_script_eval_flags_build_and_need_cuda(flags, tmp_path):
    """The eval flags build their configs and get as far as the device
    check (tests/test_torch_eval.py runs them with device="cpu")."""
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--num-envs", "4", "--iterations", "1",
                      "--log-dir", str(tmp_path)] + flags)


@pytest.mark.parametrize("flags,match", [
    (["--eval-expert"], "--num-eval-envs"),
    (["--num-eval-envs", "2", "--eval-dr", "bogus"], "not one of")])
def test_train_script_refuses_eval_flags_it_cannot_use(flags, match):
    with pytest.raises(ValueError, match=match):
        t_train.main(["--num-envs", "4", "--iterations", "1"] + flags)


def test_entry_points_raise_without_a_cuda_device(tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--num-envs", "4", "--iterations", "1", "--exact",
                      "--log-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_bench.main(num_envs=4, warmup=0, iters=1)
    # rough terrain is ported: it gets as far as the device check
    with pytest.raises(RuntimeError, match="CUDA"):
        t_train.main(["--num-envs", "4", "--iterations", "1", "--terrain",
                      "rough", "--log-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_bench.main(num_envs=4, warmup=0, iters=1, terrain="rough")
    with pytest.raises(ValueError, match="rough"):
        t_train.main(["--num-envs", "4", "--iterations", "1", "--terrain",
                      "rough", "--config", "small"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_play.play_go1(str(tmp_path / "policy_latest.npz"), steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_test.run_env(num_envs=2, steps=1)
    env = LeggedRobotEnv(t_cfg.small_train_cfg(4), device="cpu")
    # a mesh and shared checkpoints are ported (tests/test_torch_parallel.py
    # runs them): the Runner takes the env's mesh, and refuses another
    with pytest.raises(ValueError, match="mesh"):
        Runner(env, log_dir=str(tmp_path / "r"),
               mesh=mesh_mod.EnvMesh(rank=1, world_size=2))
    assert Runner(env, log_dir=str(tmp_path / "s"), args=RunnerArgs(
        shared_ckpt_dir="d")).args.shared_ckpt_dir == "d"
    with pytest.raises(ValueError, match="unknown algo"):
        Runner(env, log_dir=str(tmp_path / "r"), algo="ppo")
    # eval_expert, RMA and the videos are ported (tests/test_torch_eval.py,
    # tests/test_torch_rma.py and tests/test_torch_tools.py run them)
    assert Runner(env, log_dir=str(tmp_path / "e"),
                  args=RunnerArgs(eval_expert=True)).args.eval_expert
    assert type(Runner(env, log_dir=str(tmp_path / "m"), algo="rma")
                .train_state.policy).__name__ == "RMAPolicy"
    assert Runner(env, log_dir=str(tmp_path / "v"), args=RunnerArgs(
        render_interval=5)).args.render_interval == 5


def test_play_script_plays_back_the_exported_policy(runs, capsys):
    env, a, _ = runs
    path = os.path.join(a.log_dir, "checkpoints", "policy_latest.npz")
    policy = t_play.load_policy(path, device="cpu")
    obs = {"obs": torch.randn(2, env.num_obs),
           "obs_history": torch.randn(2, env.num_obs_history)}
    with torch.no_grad():
        want = a.train_state.policy.actor_mean(obs["obs_history"])
    assert torch.equal(policy(obs), want)
    vxs = t_play.play_go1(path, steps=3, device="cpu")
    assert vxs.shape == (3,) and np.isfinite(vxs).all()
    assert "mean body-frame vx" in capsys.readouterr().out


def test_test_script_steps_envs_on_the_cpu(capsys):
    obs = t_test.run_env(num_envs=2, steps=3, device="cpu")
    assert tuple(obs["obs"].shape) == (2, 70)
    assert capsys.readouterr().out.strip().endswith("OK")


def test_profiling_trace_and_phase_timer_on_the_cpu(tmp_path):
    """`trace` writes a Chrome trace when given a directory; on the CPU its
    summary finds no device op and a busy share of 0."""
    timer = profiling.PhaseTimer()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        with timer.phase("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    ops, busy, window_ms = profiling.device_summary(prof)
    assert ops == [] and busy == 0.0 and window_ms >= 0.0
    assert timer.counts["matmul"] == 1 and timer.summary()["matmul"][
        "total_s"] > 0
