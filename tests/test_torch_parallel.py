"""Env-axis data parallelism of the port (parallel/mesh.py) on the CPU:
torch.distributed over gloo, 2 ranks, each a process of its own.

One module fixture runs the port's
`scripts/multihost_smoke.py --device cpu --num-processes 2 --config small
--num-envs 16 --num-eval-envs 8 --num-steps 4 --iters 1 --shared-resume
--record DIR` once (each cluster on a free port found by binding port 0):
cluster A's ranks each hold 8 of the 16 train envs and 4 of the 8 eval
envs (the rand_large DR preset, a curriculum of their own) of
`small_train_cfg`, record the gathered env state after a reset and after
one step (and their own rows), train one iteration through `Runner`
(recording the gathered state after it) and commit to a shared directory;
cluster B resumes from it.  The tests hold these records against the same
work done here on one rank:

- the sharded reset and step, gathered, equal the 1-rank env's bit for bit
  (measured error 0; the tolerance is equality: every draw is the global
  draw's rows and no reduction feeds the state), and so does the state
  after the iteration's rollout (the update moves only the learner);
- `shard_env_state` of the 1-rank state equals each rank's rows bit for
  bit, `contact_lam_t` (env on the last axis, re-padded) included, and
  each rank's gather-then-shard gave its rows back;
- the 2-rank Runner iteration against the 1-rank one: parameters within
  tests/test_sharding.py's rtol 3e-3 / atol 4e-4 (measured 2.4e-5), the
  logged losses within 1e-3 and the train and eval episode counts equal,
  the ranks' parameter md5 and generator states equal;
- mirrors of tests/test_checkpoint_shared.py for `save_shared` /
  `load_shared`: round trip bit-exact, an overwrite where the latest wins
  with no `.new` / `.old` left, shape drift raises, a `Runner` shared-dir
  save and resume bit-exact; cluster B's checksum equals cluster A's
  continued one; cluster A's 2-rank checkpoint resumed by a 1-rank Runner
  is the gathered 2-rank state, bit for bit.

Against the JAX package: tests/test_torch_ppo.py's stub env and its module
fixture's JAX iterations (the noise and the permutation replayed): 2
ranks, each with its half of the envs of the JAX rollout, run the port's
`compute_gae` and `update` with the env rows; the advantages equal the
JAX normalisation over the whole batch (rtol 1e-4 / atol 1e-5, as the
1-rank test), the learning-rate sequence is the JAX one exactly, and the
parameters after the update are within test_sharding's rtol 3e-3 / atol
4e-4 of the JAX iteration's (measured below 4e-6); test_sharding (b) holds
JAX's sharded iteration to its unsharded one, so this holds the port's
collective points to the reference.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
from walk_these_ways_tpu_torch.learn import ppo as t_ppo
from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs
from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod
from walk_these_ways_tpu_torch.scripts import multihost_smoke as smoke
from walk_these_ways_tpu_torch.utils import checkpoint as ckpt
from walk_these_ways_tpu_torch.utils import convert

from process_group import kill_group
from test_torch_ppo import (A_MAT, ARGS, B_MAT, PRIV, runs)  # noqa: F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, N_EVAL, STEPS = 16, 8, 4
SMOKE = ["--device", "cpu", "--num-processes", "2", "--config", "small",
         "--num-envs", str(N), "--num-eval-envs", str(N_EVAL),
         "--num-steps", str(STEPS), "--iters", "1", "--shared-resume"]
RUNNER_ARGS = dict(num_steps_per_env=STEPS, log_freq=1,
                   save_interval=10 ** 9, curriculum_dump_freq=10 ** 9)
# tests/test_sharding.py's tolerances for a sharded iteration's parameters
RTOL, ATOL = 3e-3, 4e-4
# subprocess waits, under the 240 s wall limit of the test that waits: the
# smoke's two clusters take about 30 s alone on the CPU, the stub
# learners' test 12 s in a whole tier-1 run
SMOKE_TIMEOUT, STUB_TIMEOUT = 200, 120


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    """The 2-rank smoke started in the background; `wait()` gives
    (completed process, record dir)."""
    rec = str(tmp_path_factory.mktemp("records"))
    proc = subprocess.Popen(
        [sys.executable, "-m", smoke.MODULE, *SMOKE, "--record", rec],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=_env(), start_new_session=True)
    done = {}

    def wait():
        if not done:
            try:
                out = proc.communicate(timeout=SMOKE_TIMEOUT)[0]
            finally:
                kill_group(proc)
            done.update(out=out, rc=proc.returncode)
        return done, rec

    yield types.SimpleNamespace(wait=wait)
    kill_group(proc)


@pytest.fixture(scope="module")
def records(smoke_run):
    done, rec = smoke_run.wait()
    assert done["rc"] == 0, done["out"][-3000:]

    def load(name):
        return ckpt.load(os.path.join(rec, name + ".pkl"))
    return dict(a=[load(f"save_rank{r}") for r in range(2)],
                b=[load(f"resume_rank{r}") for r in range(2)],
                out=done["out"], dir=rec)


def _configs():
    return smoke.configs(types.SimpleNamespace(
        config="small", num_envs=N, num_eval_envs=N_EVAL))


@pytest.fixture(scope="module")
def one_rank(smoke_run, tmp_path_factory):
    """What the smoke's ranks did, on one rank here (the smoke runs
    meanwhile): the env's checks, then one Runner iteration."""
    cfg, eval_cfg = _configs()
    env = LeggedRobotEnv(cfg, eval_cfg=eval_cfg, device="cpu")
    checks = smoke.env_checks(env, STEPS)
    runner = Runner(env, log_dir=str(tmp_path_factory.mktemp("one")),
                    seed=smoke.SEED, args=RunnerArgs(**RUNNER_ARGS))
    runner.learn(1)
    return types.SimpleNamespace(checks=checks, runner=runner, env=env)


def _equal_trees(a, b, n=None):
    """Every leaf bit-equal (multihost_smoke.differing_leaves: the
    env-minor leaves on their `n` envs' lanes)."""
    assert smoke.differing_leaves(a, b, n) == []


@pytest.fixture(scope="module", autouse=True)
def _smoke_first(smoke_run):
    """The smoke starts with the module: the tests that do not read its
    records (the JAX comparison, the shared checkpoints and the mesh of
    one, above them in the file) and `one_rank` run while it does."""


# -- against the JAX package, on tests/test_torch_ppo.py's stub env ---------

STUB_WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
from walk_these_ways_tpu_torch.learn import ppo
from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod
from walk_these_ways_tpu_torch.utils import convert
inp, out = sys.argv[1], sys.argv[2]
mesh_mod.maybe_init_distributed(device="cpu")
mesh = mesh_mod.make_mesh(device="cpu")
d = pickle.load(open(inp, "rb"))
rows = mesh_mod.env_rows(mesh, d["n"])
args = ppo.PPO_Args(**d["args"])
res = []
for run in d["runs"]:
    ts = convert.train_state_from_numpy(run["before"], torch.Generator(),
                                        args, device="cpu")
    traj = ppo.Transition(*[torch.from_numpy(rows.take(x, axis=1))
                            for x in run["traj"]])
    with torch.no_grad():
        returns, advs = ppo.compute_gae(
            traj, torch.from_numpy(rows.take(run["last"])), 0.99, 0.95, rows)
    data = ppo.flatten_rollout(traj, returns, advs)
    lr, ms = ppo.update(ts.policy, (ts.optimizer, ts.adapt_optimizer), ts.lr,
                        data, torch.from_numpy(run["perm"]), args, rows)
    params = {k: v.copy() for k, v in
              convert.train_state_to_numpy(ts)["params"].items()}
    res.append(dict(advs=advs.numpy(), lr=lr, lrs=ms.lr, kl=ms.kl.numpy(),
                    value_loss=ms.value_loss.numpy(), params=params))
pickle.dump(res, open(out % mesh.rank, "wb"))
"""


def test_two_rank_learner_matches_the_jax_iteration(runs, tmp_path):
    """The stub env's two JAX iterations, the port's learner on 2 ranks of
    4 envs each from the same converted start states."""
    inp = []
    for run in runs:
        traj = [np.asarray(getattr(run["traj"], f))
                for f in t_ppo.Transition._fields]
        obs_h, acts = traj[0], traj[2]
        h_last = np.tanh(obs_h[-1] @ A_MAT + acts[-1] @ B_MAT)
        policy = convert.actor_critic_from_numpy(run["before"]["params"],
                                                 device="cpu")
        with torch.no_grad():
            last = policy.evaluate(torch.from_numpy(h_last),
                                   0.5 * torch.from_numpy(h_last)[:, :PRIV])
        inp.append(dict(before=run["before"], traj=traj, last=last.numpy(),
                        perm=np.asarray(run["perm"]).astype(np.int64)))
    path = str(tmp_path / "stub_in.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(n=runs[0]["traj"].rewards.shape[1], args=ARGS,
                         runs=inp), f)
    out = str(tmp_path / "stub_out_%d.pkl")
    port = smoke.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", STUB_WORKER, path, out], cwd=REPO,
        env=dict(_env(), RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                 LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=STUB_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            kill_group(p)
    assert [p.returncode for p in procs] == [0, 0], logs
    res = [pickle.load(open(out % r, "rb")) for r in range(2)]
    worst = 0.0
    for it, run in enumerate(runs):
        mine = [r[it] for r in res]
        adv_j = np.asarray(run["advs"])
        norm = (adv_j - adv_j.mean()) / (adv_j.std() + 1e-8)
        half = norm.shape[1] // 2
        for r in range(2):
            np.testing.assert_allclose(mine[r]["advs"],
                                       norm[:, r * half:(r + 1) * half],
                                       rtol=1e-4, atol=1e-5)
        lr_j = [float(x) for x in np.asarray(run["mb_carries"][3])]
        assert list(mine[0]["lrs"]) == list(mine[1]["lrs"]) == lr_j
        assert mine[0]["lr"] == run["after"]["lr"]
        np.testing.assert_allclose(mine[0]["kl"][0],
                                   np.asarray(run["mb_metrics"][4])[0],
                                   rtol=1e-4)
        np.testing.assert_allclose(mine[0]["value_loss"][0],
                                   np.asarray(run["mb_metrics"][0])[0],
                                   rtol=1e-4)
        assert smoke.checksum(mine[0]["params"].values()) == \
            smoke.checksum(mine[1]["params"].values())
        for key, ref in run["after"]["params"].items():
            np.testing.assert_allclose(mine[0]["params"][key], ref,
                                       rtol=RTOL, atol=ATOL, err_msg=key)
            worst = max(worst, float(np.abs(mine[0]["params"][key]
                                            - ref).max()))
    assert worst > 0.0


# -- shared-storage checkpoints (mirrors of tests/test_checkpoint_shared.py) --


def test_runner_shared_dir_save_resume_bit_exact(one_rank, tmp_path):
    """Runner.save / load on a DIRECTORY: a fresh Runner resumed from it
    holds the saver's train and env state exactly."""
    a = one_rank.runner
    shared = str(tmp_path / "shared_ckpt")
    a.save(shared)
    b = Runner(one_rank.env, log_dir=str(tmp_path / "b"), seed=99,
               args=RunnerArgs(resume=True, resume_path=shared,
                               **RUNNER_ARGS))
    _equal_trees(b._state_tree(), a._state_tree(), N + N_EVAL)
    assert b.train_state.iteration == a.train_state.iteration == 1


def _tree():
    return {"params": {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                       "b": np.ones((4,), np.float16)},
            "step": np.asarray(7, np.int32),
            "rng": torch.Generator().manual_seed(3).get_state().numpy()}


def test_save_shared_round_trip_bit_exact(tmp_path):
    path = str(tmp_path / "ckpt")
    tree = _tree()
    ckpt.save_shared(path, tree)
    back = ckpt.load_shared(path, {k: (v if not isinstance(v, dict) else
                                       {q: np.zeros_like(w)
                                        for q, w in v.items()})
                                   for k, v in tree.items()})
    _equal_trees(back, tree)


def test_save_shared_overwrites_latest_wins(tmp_path):
    path = str(tmp_path / "ckpt")
    tree = _tree()
    ckpt.save_shared(path, tree)
    tree2 = dict(tree, params={k: v + 1 for k, v in tree["params"].items()})
    ckpt.save_shared(path, tree2)
    back = ckpt.load_shared(path, tree)
    np.testing.assert_array_equal(back["params"]["w"], tree2["params"]["w"])
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_load_shared_shape_drift_and_remote_paths_fail(tmp_path):
    path = str(tmp_path / "ckpt")
    ckpt.save_shared(path, _tree())
    bad = _tree()
    bad["params"]["w"] = np.zeros((5, 4), np.float32)
    with pytest.raises(ValueError):
        ckpt.load_shared(path, bad)
    with pytest.raises(ValueError, match="remote"):
        ckpt.save_shared("gs://bucket/ckpt", _tree())


def test_save_shared_refuses_to_swap_in_a_partial_checkpoint(tmp_path):
    """Rank 0 swaps `<dir>.new` in only when every rank's part is there: on
    a mesh of two whose barrier does not wait, rank 0 alone finds rank 1's
    part missing, raises, and the previous checkpoint stays."""
    class NoWait(mesh_mod.EnvMesh):
        def barrier(self):
            pass

    path = str(tmp_path / "ck")
    ckpt.save_shared(path, _tree())
    before = sorted(os.listdir(path))
    rows = mesh_mod.env_rows(NoWait(rank=0, world_size=2), 4)
    tree = {"env_state": {"x": torch.arange(2.0)}, "policy": {"w": 1.0}}
    with pytest.raises(RuntimeError, match="rank_00001.pkl"):
        ckpt.save_shared(path, tree, rows)
    assert sorted(os.listdir(path)) == before
    assert not [f for f in os.listdir(path + ".new") if f.endswith(".tmp")]


def test_mesh_of_one_backends_and_row_map():
    """Without a process group: a mesh of one rank whose functions are
    the identity; the backend rules; rows that do not divide raise."""
    mesh = mesh_mod.make_mesh(device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    assert not mesh.distributed and "world_size=1" in repr(mesh)
    x = torch.arange(6.0)
    rows = mesh_mod.env_rows(mesh, 6)
    assert rows.take(x) is x and rows.gather([x])[0] is x
    assert mesh_mod.choose_backend("cpu") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        mesh_mod.choose_backend("cpu", "nccl")
    with pytest.raises(ValueError, match="divide"):
        mesh_mod.env_rows(mesh_mod.EnvMesh(world_size=3), 16)
    with pytest.raises(ValueError, match="process group"):
        mesh_mod.make_mesh(2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.make_mesh()
    # launched as one of several processes, but no group joined: refused,
    # not a mesh of one that trains every env as rank 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="maybe_init_distributed"):
            mesh_mod.make_mesh(device="cpu")
    if not all(k in os.environ for k in mesh_mod.ENV_VARS):
        assert not mesh_mod.maybe_init_distributed(device="cpu")
    # -0.0 fill: a gathered -0.0 stays -0.0
    two = mesh_mod.env_rows(mesh_mod.EnvMesh(rank=1, world_size=2), 4)
    buf = two._scatter(torch.tensor([-0.0, 1.0]), 0)
    assert torch.equal(torch.signbit(buf),
                       torch.tensor([True, True, True, False]))
    cfg, eval_cfg = _configs()
    with pytest.raises(ValueError, match="divide"):
        LeggedRobotEnv(dataclasses.replace(
            cfg, env=dataclasses.replace(cfg.env, num_envs=15)),
            device="cpu", mesh=mesh_mod.EnvMesh(world_size=2))


# -- the 2-rank smoke against one rank -----------------------------------------


def test_two_ranks_agree_and_a_fresh_cluster_resumes_bit_exactly(records):
    out = records["out"]
    assert "multihost_smoke: OK" in out
    assert "resumed from shared storage bit-exactly" in out
    a, b = records["a"], records["b"]
    assert a[0]["checksum"] == a[1]["checksum"]
    assert a[0]["continued_checksum"] == a[1]["continued_checksum"] \
        == b[0]["checksum"] == b[1]["checksum"]
    assert a[0]["generator_checksums"] == a[1]["generator_checksums"]
    assert b[0]["generator_checksums"] == b[1]["generator_checksums"]
    assert [r["world_size"] for r in a + b] == [2, 2, 2, 2]
    assert "backend=gloo" in a[0]["mesh"]
    assert a[0]["iterations"] == 1 and b[0]["iterations"] == 2


@pytest.mark.parametrize("what", ["reset", "step"])
def test_sharded_env_equals_one_rank_bit_for_bit(records, one_rank, what):
    """The split env (8 + 8 envs; a train and an eval curriculum) on 2
    ranks, gathered, against the same env on one rank."""
    _equal_trees(records["a"][0][what], one_rank.checks[what], N + N_EVAL)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_and_gather_round_trip(records, one_rank, rank):
    rec = records["a"][rank]
    assert rec["roundtrip_bit_exact"]
    rows = mesh_mod.env_rows(mesh_mod.EnvMesh(rank=rank, world_size=2), N,
                             N_EVAL)
    for what in ("reset", "step"):
        whole = one_rank.checks[what]
        mine = {k: mesh_mod.shard_env_state(whole[k], rows)
                for k in ("env_state", "obs_dict")}
        _equal_trees(mine, rec["local_" + what], rows.n)
    lam = rec["local_step"]["env_state"]["contact_lam_t"]
    assert lam.shape[-1] == 128 and np.abs(lam[..., :rows.n]).max() > 0
    assert not lam[..., rows.n:].any()
    # the rank's rows: its 8 train envs, then its 4 eval envs
    assert list(rows.global_index()) == (
        list(range(rank * 8, rank * 8 + 8))
        + list(range(N + rank * 4, N + rank * 4 + 4)))


def test_two_rank_runner_iteration_matches_one_rank(records, one_rank):
    got = records["a"][0]["params"]
    want = convert.train_state_to_numpy(one_rank.runner.train_state)[
        "params"]
    worst = 0.0
    for key, ref in want.items():
        np.testing.assert_allclose(got[key], ref, rtol=RTOL, atol=ATOL,
                                   err_msg=key)
        worst = max(worst, float(np.abs(got[key] - ref).max()))
    assert 0.0 < worst < 1e-4
    row = json.loads(open(os.path.join(one_rank.runner.log_dir,
                                       "metrics.jsonl")).readline())
    got = records["a"][0]["metrics"][0]
    for k in ("mean_value_loss", "mean_surrogate_loss", "adaptation_loss",
              "mean_kl", "mean_reward_per_step"):
        np.testing.assert_allclose(got[k], row[k], rtol=1e-3, atol=1e-7,
                                   err_msg=k)
    for k in row:
        if "min_" in k or "max_" in k or k.endswith("episode_length"):
            assert got[k] == row[k], k
    assert got["timesteps"] == row["timesteps"] == STEPS * (N + N_EVAL)


def test_rma_iteration_on_two_ranks_matches_one_rank(records, one_rank):
    """learn/ppo_rma on the split env: 2 ranks against one, parameters at
    test_sharding's tolerances, the ranks' checksums equal, the logged
    losses within 1e-3."""
    got = [r["rma"] for r in records["a"]]
    want = one_rank.checks["rma"]
    assert got[0]["checksum"] == got[1]["checksum"]
    _equal_trees(got[0]["before"], want["before"])
    moved = 0.0
    for key, ref in want["params"].items():
        np.testing.assert_allclose(got[0]["params"][key], ref, rtol=RTOL,
                                   atol=ATOL, err_msg=key)
        moved = max(moved, float(np.abs(ref - want["before"][key]).max()))
    assert moved > 1e-4
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got[0]["metrics"][k], v, rtol=1e-3,
                                   atol=1e-7, err_msg=k)


def test_rollout_of_the_iteration_equals_one_rank(records, one_rank):
    """The state after the Runner's iteration, gathered: its rollout ran
    on the same parameters, so it is the 1-rank state bit for bit (train
    and eval slices, both curricula)."""
    tree = one_rank.runner._state_tree()
    _equal_trees(records["a"][0]["saved"],
                 {k: tree[k] for k in ("env_state", "obs_dict")}, N + N_EVAL)


def test_two_rank_checkpoint_resumes_on_one_rank(records, one_rank,
                                                 tmp_path):
    """Cluster A's shared directory (2 ranks of 8 envs) into a 1-rank
    Runner: the state it loads is the gathered 2-rank state."""
    r = Runner(one_rank.env, log_dir=str(tmp_path), seed=5,
               args=RunnerArgs(resume=True, resume_path=os.path.join(
                   records["dir"], "shared_ckpt"), **RUNNER_ARGS))
    saved = records["a"][0]["saved"]
    tree = r._state_tree()
    _equal_trees({k: tree[k] for k in ("env_state", "obs_dict")}, saved,
                 N + N_EVAL)
    _equal_trees(tree["train_state"]["params"], records["a"][0]["params"])
    assert r.train_state.iteration == 1
