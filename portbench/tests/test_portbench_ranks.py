"""A cell over several ranks on the CPU: two ranks on gloo, 32 envs of
`cse_flat_16384_dp4` at 3 control steps an iteration, started and joined as
a run starts them (ranks_probe.py drives `harness.run_cell` in each).

- The capture rank 0 joins is each rank's capture, its env rows in the
  global batch's order.
- It is what one process computes where the program's ranks compute it bit
  for bit (the parallel/mesh tests): the reset's observations, and the env
  step from the joined state before each sampled step, which a one-rank env
  of the whole batch takes to the joined outputs.
- The one-rank reference follows it to agreement: the run is `correct`,
  the env's numbers read 0 and the learner's only the ranks' other order
  of summation.
- With a fault planted under the timed path (on the last rank; the
  exchange on every rank) the run is not correct.
On the card (`gpu`, four cards): one run of the cell with a 5-second
window."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import harness, spec
from portbench.tests import ranks_probe

SEED = 2**31 + 1913
ENVS, RANKS = 32, 2


FAULTS = ("none", "half_batch", "three_envs_stale", "answer_altered",
          "state_unchanged", "exchange_left_out")


def probe(*args):
    """The probe started over RANKS ranks with `args`."""
    return subprocess.Popen(
        [sys.executable, "-m", "portbench.tests.ranks_probe", "--ranks",
         str(RANKS), "--envs", str(ENVS), "--seed", str(SEED), *args],
        cwd=spec.ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=spec.ROOT))


def lines(proc, timeout=240):
    """(the JSON lines of the probe's standard output, its standard
    error), once it has exited with 0."""
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-4000:]
    return [json.loads(ln) for ln in out.splitlines()
            if ln.startswith("{")], err


@pytest.fixture(scope="module")
def faults():
    """The planted faults' probe, started first: it runs beside the
    others."""
    proc = probe("--faults", ",".join(FAULTS))
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def run(tmp_path_factory, faults):
    d = tmp_path_factory.mktemp("ranks")
    out, err = lines(probe("--dump", str(d)))
    return dict(result=out[-1], err=err,
                joined=torch.load(d / "joined.pt", weights_only=False),
                local=[torch.load(d / f"local{r}.pt", weights_only=False)
                       for r in range(RANKS)])


def test_run_over_two_ranks_is_correct(run):
    res = run["result"]
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == RANKS
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    c = res["checks"]
    for n in ("physics", "obs", "reward", "done", "policy"):
        assert c[n]["value"] == 0.0, (n, c[n])
    for n in ("gae", "loss_first", "grad", "change", "change_median"):
        assert c[n]["value"] < 1e-5, (n, c[n])
    # every line a worker wrote came to rank 0's standard error, marked
    assert "rank 1: portbench: setup" in run["err"]


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and bool(
            torch.equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def test_joined_capture_is_every_ranks_rows(run):
    j, loc = run["joined"], run["local"]
    n = ENVS // RANKS
    for k, traj in enumerate(j["traj"]):
        for f, v in traj.items():
            assert _same(v, torch.cat([x["traj"][k][f] for x in loc], 1)), f
        for f, v in j["raw"][k].items():
            assert _same(v, torch.cat([x["raw"][k][f] for x in loc], 1)), f
        for f, v in j["last_obs"][k].items():
            assert _same(v, torch.cat([x["last_obs"][k][f] for x in loc]))
        steps = traj["actions"].shape[0]
        for i in range(2):
            want = torch.cat([x["gae"][k][i].view(steps, n) for x in loc],
                             1).reshape(-1)
            assert _same(j["gae"][k][i], want)
    for c, *cs in zip(j["env_checks"], *(x["env_checks"] for x in loc)):
        assert c["key"] == cs[0]["key"] == cs[1]["key"]
        assert _same(c["actions"], torch.cat([x["actions"] for x in cs]))
        st = c["post"][0][1]
        for f in ("torques", "obs_history", "episode_length"):
            assert _same(st[f], torch.cat([x["post"][0][1][f] for x in cs]))
        lam = st["contact_lam_t"]
        assert _same(lam[..., :ENVS], torch.cat(
            [x["post"][0][1]["contact_lam_t"][..., :n] for x in cs], -1))
        assert not lam[..., ENVS:].any()
        # one value for the whole batch: rank 0's, the same on every rank
        for f in ("common_step", "curriculum", "rng", "gravity_offset"):
            assert _same(c["pre"][1][f], cs[0]["pre"][1][f])
            assert _same(cs[0]["pre"][1][f], cs[1]["pre"][1][f])
    # the replicated learner: rank 0's, and the other rank's beside it
    assert _same(j["params_after"], loc[0]["params_after"])
    assert len(j["replicas"]) == RANKS - 1
    assert _same(j["replicas"][0]["params_after"], loc[1]["params_after"])
    assert _same(j["replicas"][0]["first_grad"], loc[1]["first_grad"])


def test_joined_capture_is_one_processs(run):
    """The reset's observations of a one-process job of the whole batch,
    and a one-rank env's step from each joined state before a sampled step
    with the joined actions, are the joined capture's, bit for bit (the
    card's index_add sums the curriculum's per-bin task sums in another
    order, held to 1e-6 as in the parallel/mesh tests)."""
    from walk_these_ways_tpu_torch.envs import go1_env

    from portbench import check, job
    torch.set_num_threads(1)
    cell = ranks_probe.small_cell(ENVS, 1)
    one = job.build(job.side(job.PROGRAM, cell.config), cell,
                    torch.device("cpu"), SEED)
    j = run["joined"]
    assert _same(j["traj"][0]["obs_history"][0],
                 one.obs_dict["obs_history"])
    types = {"EnvState": go1_env.EnvState,
             "PhysicsState": one.side.engine.PhysicsState,
             "CurriculumState": one.side.curriculum.CurriculumState}
    assert j["env_checks"]
    for c in j["env_checks"]:
        pre = check.from_host(c["pre"], types, torch.device("cpu"))
        st, obs, rew, done, _ = one.env.step(pre, c["actions"])
        st_p, obs_p, rew_p, done_p = c["post"]
        assert _same(rew, rew_p) and _same(done, done_p)
        for k, v in obs.items():
            assert _same(v, obs_p[k]), k
        for f in go1_env.EnvState._fields:
            want, got = getattr(st, f), st_p[1][f]
            if f == "phys":
                for g in want._fields:
                    assert _same(getattr(want, g), got[1][g]), g
            elif f == "curriculum":
                assert _same(want.weights, got[1]["weights"])
                assert torch.allclose(want.bin_task_sums,
                                      got[1]["bin_task_sums"], rtol=1e-6,
                                      atol=1e-6)
            elif isinstance(want, torch.Tensor):
                assert _same(want, got), f


def test_planted_faults_are_not_correct(faults):
    out, _ = lines(faults)
    got = {ln["fault"]: ln["correct"] for ln in out}
    assert got == {f: f == "none" for f in FAULTS}, out


@pytest.mark.gpu
def test_run_on_four_cards():
    """One run of `cse_flat_16384_dp4` with a 5-second window: `correct`,
    every end-to-end metric there, no rank left running."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "cse_flat_16384_dp4", "--seed", str(SEED), "--seconds", "5",
         "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    cell = spec.load_cell("cse_flat_16384_dp4")
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert res["device"]["count"] == 4
    assert not harness.forbidden_modules()
