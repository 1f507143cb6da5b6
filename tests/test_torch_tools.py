"""The port's videos and tool scripts vs the JAX package, on the CPU.

- `utils/render`: `_skeleton_points` (the port's `forward_kinematics`)
  against the JAX one on the same PhysicsState, rtol 1e-5 / atol 1e-6
  (largest error seen 4.2e-8); `render_trajectory` writes a GIF of the
  frames asked for;
- `Runner(render_interval, render_steps)` writes `videos/*.gif` (the JAX
  package's `tests/test_ppo.py::test_runner_log_keys_and_video`), and
  `log_video` leaves the env state, the policy and the generators as they
  were; `play_go1` with a
  video path on the runner's export;
- `models/actuator_net.init_random` is bit-equal to JAX's;
  `scripts/actuator_net_train.build_dataset`, on a synthetic log*.pkl in
  the deploy logger's format, is bit-equal to the JAX package's script;
  its `train` (torch Adam) against the JAX script's (optax Adam) over the
  same batches, 1e-5 absolute (largest seen 3.0e-7 after 24 Adam steps);
  `scripts/actuator_net_eval`'s JSON against the JAX script's on the same
  logs, rtol 1e-5 (float32 forward passes, other summation order);
- `scripts/validate_adaptation_cross_engine.main(device="cpu")` at 8 envs
  and a few steps; `scripts/profile_train` reaches the CUDA check.
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from walk_these_ways_tpu.models import actuator_net as j_anet
from walk_these_ways_tpu.models import robot as j_robot
from walk_these_ways_tpu.physics import engine as j_eng
from walk_these_ways_tpu.utils import render as j_render

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs
from walk_these_ways_tpu_torch.models import actuator_net as t_anet
from walk_these_ways_tpu_torch.models import robot as t_robot
from walk_these_ways_tpu_torch.physics import engine as t_eng
from walk_these_ways_tpu_torch.scripts import actuator_net_eval as t_ane
from walk_these_ways_tpu_torch.scripts import actuator_net_train as t_ant
from walk_these_ways_tpu_torch.scripts import play as t_play
from walk_these_ways_tpu_torch.scripts import profile_train as t_prof
from walk_these_ways_tpu_torch.scripts import (
    validate_adaptation_cross_engine as t_vace)
from walk_these_ways_tpu_torch.utils import convert
from walk_these_ways_tpu_torch.utils import render as t_render

from test_torch_util import REPO, assert_close, random_phys_np, t

# the JAX package's tool scripts import each other as top-level modules
sys.path.insert(0, os.path.join(REPO, "scripts"))
import actuator_net_eval as j_ane  # noqa: E402
import actuator_net_train as j_ant  # noqa: E402

torch.set_num_threads(1)


def test_skeleton_points_match_jax():
    ph = random_phys_np(4, 11)
    jm, tm = j_robot.go1(), t_robot.go1()
    phys_t = t_eng.PhysicsState(**{k: t(v) for k, v in ph.items()})
    phys_j = j_eng.PhysicsState(**ph)
    for env_idx in (0, 3):
        p_t, f_t = t_render._skeleton_points(tm, phys_t, env_idx)
        p_j, f_j = j_render._skeleton_points(jm, phys_j, env_idx)
        assert p_t.shape == (tm.nb, 3) and f_t.shape == (4, 3)
        assert_close(p_t, p_j, 1e-5, 1e-6)
        assert_close(f_t, f_j, 1e-5, 1e-6)


def test_render_trajectory_writes_a_gif(tmp_path):
    frames = [t_eng.PhysicsState(**{k: t(v) for k, v in
                                    random_phys_np(1, s).items()})
              for s in (12, 13, 14)]
    out = str(tmp_path / "three.gif")
    assert t_render.render_trajectory(t_robot.go1(), frames, out, fps=10) \
        == out
    assert os.path.getsize(out) > 0
    import imageio
    assert len(imageio.mimread(out)) == 3


@pytest.fixture(scope="module")
def video_run(tmp_path_factory):
    """small_train_cfg(8) for 2 iterations of 2 steps, a video (3 steps)
    after each."""
    env = LeggedRobotEnv(t_cfg.small_train_cfg(8), device="cpu")
    r = Runner(env, log_dir=str(tmp_path_factory.mktemp("video")),
               args=RunnerArgs(num_steps_per_env=2, max_iterations=2,
                               log_freq=2, save_interval=1000,
                               curriculum_dump_freq=1000, render_interval=1,
                               render_steps=3))
    r.learn(2)
    return r


def test_runner_log_keys_and_video(video_run):
    r = video_run
    rows = [json.loads(line) for line in
            open(os.path.join(r.log_dir, "metrics.jsonl"))]
    row = rows[-1]
    for key in ("train/episode/min_command_x_vel",
                "train/episode/max_command_duration",
                "train/episode/min_action", "train/episode/max_action"):
        assert key in row and np.isfinite(row[key]), key
    assert row["train/episode/min_command_x_vel"] <= \
        row["train/episode/max_command_x_vel"]
    videos = sorted(os.listdir(os.path.join(r.log_dir, "videos")))
    assert videos == ["00001.gif", "00002.gif"]
    assert all(os.path.getsize(os.path.join(r.log_dir, "videos", v)) > 0
               for v in videos)


def test_videos_leave_the_training_stream_alone(video_run, capsys):
    """`log_video` steps a throwaway copy of the env state with a generator
    of its own: the env state, the observations, the policy and both
    generators' streams are as they were."""
    r = video_run
    env_before = convert.env_state_to_numpy(r.env_state)
    obs_before = {k: v.clone() for k, v in r.obs_dict.items()}
    params_before = [p.detach().clone()
                     for p in r.train_state.policy.parameters()]
    rng_before = r.train_state.rng.get_state()
    path = r.log_video(3)
    capsys.readouterr()
    assert os.path.getsize(path) > 0
    env_after = convert.env_state_to_numpy(r.env_state)
    for name, x in env_before.items():
        if isinstance(x, dict):
            for k in x:
                np.testing.assert_array_equal(x[k], env_after[name][k])
        elif x is not None:
            np.testing.assert_array_equal(x, env_after[name], err_msg=name)
    for k, v in obs_before.items():
        assert torch.equal(r.obs_dict[k], v), k
    for p, q in zip(r.train_state.policy.parameters(), params_before):
        assert torch.equal(p, q)
    assert torch.equal(r.train_state.rng.get_state(), rng_before)


def test_play_writes_a_video(video_run, tmp_path, capsys):
    r = video_run
    path = os.path.join(r.log_dir, "checkpoints", "policy_latest.npz")
    out = str(tmp_path / "play.gif")
    vxs = t_play.play_go1(path, steps=4, video_path=out, device="cpu")
    assert vxs.shape == (4,) and np.isfinite(vxs).all()
    assert os.path.getsize(out) > 0
    assert "saved gait video" in capsys.readouterr().out


def test_init_random_is_bit_equal_to_jax():
    for seed in (None, 5):
        a, b = t_anet.init_random(seed, device="cpu"), j_anet.init_random(seed)
        for k in t_ant.PARAM_NAMES:
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)))


def _write_logs(log_dir, seed, T=60):
    """Two deploy-logger pickles of PD-behaved joints, one episode without
    torques (skipped by both scripts)."""
    rs = np.random.RandomState(seed)
    os.makedirs(log_dir, exist_ok=True)
    for f in range(2):
        eps = {}
        for e in range(2):
            q = 0.1 * rs.randn(T, 12)
            qd = 0.5 * rs.randn(T, 12)
            q_tgt = q + 0.05 * rs.randn(T, 12)
            tau = 20.0 * (q_tgt - q) - 0.5 * qd + 0.1 * rs.randn(T, 12)
            eps[f"ep{e}"] = {"joint_pos": [q[:T // 2], q[T // 2:]],
                             "joint_vel": [qd], "joint_pos_target": [q_tgt],
                             "tau_est": [tau], "torques": [tau]}
        eps["no_torques"] = {"joint_pos": [q]}
        with open(os.path.join(log_dir, f"log_{f}.pkl"), "wb") as fh:
            pickle.dump(eps, fh)


@pytest.fixture(scope="module")
def logs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("deploy_logs"))
    _write_logs(d, 0)
    return d


def test_build_dataset_is_bit_equal_to_the_jax_script(logs):
    x, y = t_ant.build_dataset(logs)
    xj, yj = j_ant.build_dataset(logs)
    assert x.shape == (2 * 2 * 58 * 12, 6) and y.shape == (x.shape[0], 1)
    assert x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(x, xj)
    np.testing.assert_array_equal(y, yj)


def test_actuator_net_train_matches_the_optax_loop(logs, tmp_path):
    x, y = t_ant.build_dataset(logs)
    kw = dict(epochs=3, batch_size=256, lr=8e-4, seed=2)
    mine = t_ant.train(x, y, device="cpu", **kw)
    theirs = j_ant.train(x, y, **kw)
    moved = 0.0
    init = t_anet.init_random(2, device="cpu")
    for k in t_ant.PARAM_NAMES:
        assert_close(getattr(mine, k), np.asarray(getattr(theirs, k)), 0,
                     1e-5, err_msg=k)
        moved = max(moved, float((getattr(mine, k) - getattr(init, k))
                                 .abs().max()))
    assert moved > 1e-3
    out = str(tmp_path / "net.npz")
    t_ant.save(mine, out)
    z = np.load(out)
    assert sorted(z.files) == sorted(t_ant.PARAM_NAMES)
    np.testing.assert_array_equal(z["w1"], mine.w1.numpy())


def test_actuator_net_eval_matches_the_jax_script(logs, tmp_path,
                                                  monkeypatch, capsys):
    out_t, out_j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    net = os.path.join(REPO, "resources", "actuator_nets", "unitree_go1.npz")
    t_ane.main(["--log-dir", logs, "--net", net, "--out", out_t,
                "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["actuator_net_eval.py", "--log-dir",
                                      logs, "--net", net, "--out", out_j])
    j_ane.main()
    capsys.readouterr()
    rt, rj = (json.load(open(p)) for p in (out_t, out_j))
    assert rt.keys() == rj.keys() and len(rt["per_joint"]) == 12
    assert rt["samples"] == rj["samples"] == 2 * 2 * 58 * 12
    for k in ("mse", "r2", "mse_pd_baseline"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=1e-5, err_msg=k)
    for j, stats in rt["per_joint"].items():
        for k, v in stats.items():
            np.testing.assert_allclose(v, rj["per_joint"][j][k], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{j} {k}")


def test_validate_adaptation_cross_engine_on_the_cpu(video_run, tmp_path,
                                                     capsys):
    r = video_run
    pol = os.path.join(r.log_dir, "checkpoints", "policy_latest.npz")
    ref = os.path.join(REPO, "resources", "reference_policy",
                       "pretrain_v0_policy.npz")
    out = str(tmp_path / "adaptation.json")
    res = t_vace.main(pol, ref, num_envs=8, warmup_steps=1, collect_steps=10,
                      out_path=out, device="cpu")
    capsys.readouterr()
    assert res["samples"] == 8 and res["device"] == "cpu"
    assert json.load(open(out))["mse_our_module"] == res["mse_our_module"]
    for k in ("mse_reference_module", "mse_our_module",
              "mse_predict_mean_baseline"):
        assert np.isfinite(res[k]) and res[k] >= 0, k
    assert len(res["target_mean"]) == 2
    assert set(res["controls_reference_module"]) == {"feature_shuffled",
                                                     "marginal_gaussian"}
    with pytest.raises(SystemExit):
        t_vace.cli(["--policy", str(tmp_path / "missing.npz")])


def test_tool_scripts_need_cuda(logs, tmp_path):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_prof.main(["--num-envs", "4", "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ant.main(["--log-dir", logs, "--out", str(tmp_path / "n.npz"),
                    "--epochs", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ane.main(["--log-dir", logs])
    pol = os.path.join(REPO, "resources", "reference_policy",
                       "pretrain_v0_policy.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_vace.main(pol, pol, 2, 1, 1, None)
