"""Training loop.

Counterpart of the JAX package's learn/runner.py (reference:
go1_gym_learn/ppo_cse/__init__.py:62-308).  The per-iteration work —
24-step rollout + GAE + PPO + adaptation update — is
`learn/ppo.make_train_iteration`; this host loop dispatches iterations,
drains the logging accumulators at `log_freq` only (one device-to-host copy
per log row, none per iteration), checkpoints, and exports the deployable
policy (adaptation module + actor body as a flat .npz of weights, the same
keys, shapes and `meta/variant` as the JAX package's export, so `deploy/`
and `scripts/play.py` read it).

Artifacts in `log_dir`, under the JAX package's names: `metrics.jsonl`,
`.charts.yml`, `provenance.json`, `checkpoints/train_state_*.pkl`,
`checkpoints/policy_latest.npz`, `curriculum/distribution_*.npz`.

With eval envs in the env (its train/eval split), the eval slice acts
deterministically (the teacher with `RunnerArgs.eval_expert`) and its
finished episodes are logged under `eval/episode/*`.  With
`render_interval`, a short rollout of env 0 under the student policy is
drawn to `videos/<iteration>.gif` every `render_interval` iterations.

With an env mesh (`mesh`, parallel/mesh.py; the env built on it holds
its rank's rows), every rank runs this loop on its rows and the learner
state stays replicated: `Runner(mesh=...)` broadcasts rank 0's after the
reset, the command and action diagnostics are taken over every rank's
train rows, and the timesteps count the global batch.  Only rank 0 writes
`metrics.jsonl`, `.charts.yml`, `provenance.json`, the pickles (of the
gathered state), the curriculum dumps, the videos and the export; every
rank takes part in a shared-storage checkpoint (`shared_ckpt_dir`, or a
directory given to `save` / `load`), which it writes its rows into.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from ..envs import curriculum as curr
from ..envs.go1_env import make_generator
from ..parallel import mesh as mesh_mod
from ..physics.engine import PhysicsState
from ..utils import checkpoint as ckpt
from ..utils import convert
from ..utils.metrics_logger import MetricsLogger
from . import ppo as ppo_mod
from . import ppo_rma


@dataclasses.dataclass(frozen=True)
class RunnerArgs:
    """reference ppo_cse/__init__.py:43-59"""
    num_steps_per_env: int = 24
    max_iterations: int = 1500
    save_interval: int = 400
    log_freq: int = 10
    resume: bool = False
    # *.pkl = local pickle; anything else = a shared-storage directory
    resume_path: Optional[str] = None
    # shared-storage checkpoint directory (utils/checkpoint.save_shared),
    # committed at every save interval and at the end of `learn`
    shared_ckpt_dir: Optional[str] = None
    # curriculum weight-grid + per-bin reward-mean dump cadence (reference
    # curriculum_dump_freq=500, ppo_cse/__init__.py:107,193-202)
    curriculum_dump_freq: int = 500
    # eval envs act with the teacher (act_teacher) instead of the student
    eval_expert: bool = False
    # render a short student-policy rollout every N iterations (0 = off);
    # analog of the reference's save_video_interval camera capture
    render_interval: int = 0
    render_steps: int = 100


# IterMetrics fields drained at log_freq, in this order
_DRAINED = ("value_loss", "surrogate_loss", "adaptation_loss",
            "adaptation_test_loss", "mean_kl", "mean_reward", "ep_sums_done",
            "ep_count_done", "ep_len_done", "eval_ep_sums_done",
            "eval_ep_count_done", "eval_ep_len_done", "curriculum_area",
            "envelope_exits")


def _drain(pending):
    """IterMetrics on the device -> dicts of numpy, in one copy."""
    sizes = [getattr(pending[0], f).numel() for f in _DRAINED]
    flat = torch.cat([torch.cat([getattr(m, f).reshape(-1).to(torch.float64)
                                 for f in _DRAINED]) for m in pending])
    flat = flat.cpu().numpy().reshape(len(pending), -1)
    out = []
    for row, m in zip(flat, pending):
        d, k = {"lr": m.lr}, 0
        for f, n in zip(_DRAINED, sizes):
            d[f] = row[k:k + n] if n > 1 else row[k]
            k += n
        out.append(d)
    return out


class Runner:
    def __init__(self, env, log_dir: str = "./runs/latest", seed: int = 1,
                 args: RunnerArgs = RunnerArgs(),
                 ppo_args: ppo_mod.PPO_Args = ppo_mod.PPO_Args(),
                 algo: str = "cse", mesh=None):
        """algo: 'cse' (concurrent state estimation, the default trainer,
        reference ppo_cse/) or 'rma' (teacher-student with an env-factor
        encoder, reference ppo/, learn/ppo_rma.py).  Both variants emit the
        same IterMetrics, so logging, checkpoints and the export are
        shared.  `mesh` (parallel/mesh.EnvMesh) is the env's: it splits the
        envs over its ranks (module docstring)."""
        algos = {"cse": ppo_mod, "rma": ppo_rma}
        if algo not in algos:
            raise ValueError(f"unknown algo {algo!r} (want 'cse' or 'rma')")
        if mesh is not None and mesh != env.mesh:
            raise ValueError(f"Runner(mesh={mesh!r}) on an env built on "
                             f"{env.mesh!r}: build the env with "
                             "LeggedRobotEnv(..., mesh=mesh)")
        self.mesh = env.mesh
        self.rows = env.rows
        self.rank0 = env.rows.mesh.rank == 0
        self._algo_mod = algos[algo]
        self.env = env
        self.args = args
        self.ppo_args = ppo_args
        self.algo = algo
        self.log_dir = log_dir
        self.logger = MetricsLogger(log_dir) if self.rank0 else None
        if self.rank0:
            self._write_chart_spec()
            self._write_provenance(seed)

        ts_seed, self._reset_seed = (
            int(x) for x in np.random.SeedSequence(seed).generate_state(2))
        self.train_state = self._algo_mod.init_train_state(
            make_generator(ts_seed, env.device), env, ppo_args)
        self.train_iter = self._algo_mod.make_train_iteration(
            env, ppo_args, num_steps=args.num_steps_per_env,
            eval_expert=args.eval_expert)
        self.env_state = None
        self.obs_dict = None
        self.tot_timesteps = 0

        if args.resume and args.resume_path:
            self.load(args.resume_path)

    def learn(self, num_learning_iterations: Optional[int] = None,
              init_at_random_ep_len: bool = True):
        n_iters = num_learning_iterations or self.args.max_iterations
        if self.env_state is None:
            # an env on a mesh resets to its rank's rows of the one-rank
            # reset; the learner state is rank 0's on every rank
            self.env_state, self.obs_dict = self.env.reset(
                make_generator(self._reset_seed, self.env.device),
                random_episode_lengths=init_at_random_ep_len)
            mesh_mod.replicate(self.train_state, self.mesh)

        term_names = list(self.env.reward_names) + ["total"]
        ep_sums_acc = np.zeros(len(term_names))
        ep_count_acc = 0.0
        ep_len_acc = 0.0
        ev_sums_acc = np.zeros(len(term_names))
        ev_count_acc = 0.0
        ev_len_acc = 0.0
        env_exit_acc = 0.0       # cumulative crash-guard terminations
        t_start = time.time()

        start_iter = int(self.train_state.iteration)
        pending = []     # metrics on the device; drained at log_freq only
        t_window = time.time()
        for it in range(start_iter, start_iter + n_iters):
            self.env_state, self.obs_dict, self.train_state, metrics = \
                self.train_iter(self.env_state, self.obs_dict,
                                self.train_state)
            pending.append(metrics)
            self.tot_timesteps += self.args.num_steps_per_env \
                * self.env.num_envs_global

            if (it + 1) % self.args.log_freq == 0:
                iter_time = (time.time() - t_window) / max(len(pending), 1)
                t_window = time.time()
                drained = _drain(pending) if self.rank0 else []
                pending = []
                # command/action range diagnostics over every rank's train
                # rows (reference legged_robot.py:203-227)
                n_tr = self.env.num_train_envs
                cmds, acts = (
                    x.cpu().numpy() for x in self.rows.train_only().gather(
                        [self.env_state.commands[:n_tr],
                         self.env_state.actions[:n_tr]]))
                for m in drained:
                    ep_sums_acc += m["ep_sums_done"]
                    ep_count_acc += float(m["ep_count_done"])
                    ep_len_acc += float(m["ep_len_done"])
                    ev_sums_acc += m["eval_ep_sums_done"]
                    ev_count_acc += float(m["eval_ep_count_done"])
                    ev_len_acc += float(m["eval_ep_len_done"])
                    env_exit_acc += float(m["envelope_exits"])
                    self.logger.store(
                        mean_value_loss=m["value_loss"],
                        mean_surrogate_loss=m["surrogate_loss"],
                        adaptation_loss=m["adaptation_loss"],
                        mean_adaptation_module_test_loss=m[
                            "adaptation_test_loss"],
                        mean_kl=m["mean_kl"], lr=m["lr"],
                        mean_reward_per_step=m["mean_reward"],
                        time_iter=iter_time,
                    )
                    area = np.atleast_1d(m["curriculum_area"])
                    for c, name in enumerate(curr.CATEGORY_NAMES):
                        self.logger.store(**{f"command_area_{name}":
                                             float(area[c])})
                extra = {"iterations": it + 1, "timesteps": self.tot_timesteps,
                         # cumulative count of integrator-envelope crash
                         # terminations (healthy runs stay at 0)
                         "train/episode/envelope_exits_total": env_exit_acc}
                for key, col in (("duration", 8), ("bound", 7),
                                 ("offset", 6), ("phase", 5), ("freq", 4),
                                 ("x_vel", 0), ("y_vel", 1), ("yaw_vel", 2),
                                 ("swing_height", 9)):
                    extra[f"train/episode/min_command_{key}"] = \
                        float(cmds[:, col].min())
                    extra[f"train/episode/max_command_{key}"] = \
                        float(cmds[:, col].max())
                extra["train/episode/min_action"] = float(acts.min())
                extra["train/episode/max_action"] = float(acts.max())
                if ep_count_acc > 0:
                    for i, name in enumerate(term_names):
                        extra[f"train/episode/rew_{name}/mean"] = (
                            ep_sums_acc[i] / ep_count_acc)
                    extra["train/episode/mean_episode_length"] = (
                        ep_len_acc / ep_count_acc)
                if ev_count_acc > 0:
                    for i, name in enumerate(term_names):
                        extra[f"eval/episode/rew_{name}/mean"] = (
                            ev_sums_acc[i] / ev_count_acc)
                    extra["eval/episode/mean_episode_length"] = (
                        ev_len_acc / ev_count_acc)
                ep_sums_acc[:] = 0.0
                ep_count_acc = 0.0
                ep_len_acc = 0.0
                ev_sums_acc[:] = 0.0
                ev_count_acc = 0.0
                ev_len_acc = 0.0
                if self.rank0:
                    row = self.logger.summary(**extra)
                    steps_s = self.tot_timesteps / max(time.time() - t_start,
                                                       1e-9)
                    print(f"it {it+1:5d} | rew/step "
                          f"{row.get('mean_reward_per_step', 0):.4f} | "
                          f"vloss {row.get('mean_value_loss', 0):.3f} | "
                          f"aloss {row.get('adaptation_loss', 0):.5f} | "
                          f"env-steps/s {steps_s:,.0f}", flush=True)

            if self.rank0 and (it + 1) % self.args.curriculum_dump_freq == 0:
                self.dump_curriculum(it + 1)

            if (it + 1) % self.args.save_interval == 0:
                self.save(os.path.join(self.log_dir, "checkpoints",
                                       f"train_state_{it+1:06d}.pkl"))
                self.export_policy(os.path.join(self.log_dir, "checkpoints"))
                if self.args.shared_ckpt_dir:
                    self.save(self.args.shared_ckpt_dir)

            if (self.args.render_interval
                    and (it + 1) % self.args.render_interval == 0):
                self.log_video(it + 1)

        self.save(os.path.join(self.log_dir, "checkpoints",
                               "train_state_last.pkl"))
        self.export_policy(os.path.join(self.log_dir, "checkpoints"))
        if self.args.shared_ckpt_dir:
            self.save(self.args.shared_ckpt_dir)
        return self.train_state

    def _write_provenance(self, seed: int):
        """Stamp the run dir with everything needed to reproduce it: git
        SHA (+dirty flag), a stable hash of the resolved env config, the
        resolved SimParams, runner/ppo args, argv, the torch and CUDA
        versions and the GPU's name, and the machine-load context (loadavg
        + other live python processes) so throughput anomalies are
        explicable from the artifact alone.

        Dirty-tree runs are loudly warned about; WTW_REQUIRE_CLEAN=1 turns
        the warning into a hard error."""
        import hashlib
        import json
        import subprocess
        import sys
        from datetime import datetime

        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        sha, dirty = None, None
        try:
            sha = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=repo, capture_output=True,
                text=True, timeout=10).stdout.strip() or None
            dirty = bool(subprocess.run(
                ["git", "status", "--porcelain", "--untracked-files=no"],
                cwd=repo, capture_output=True, text=True,
                timeout=10).stdout.strip())
        except Exception:
            pass
        if dirty or (dirty is None and os.environ.get("WTW_REQUIRE_CLEAN")):
            msg = ("PROVENANCE: the git tree is DIRTY - this run cannot be "
                   "reproduced from any committed SHA.  Commit first (or "
                   "accept a provenance.json with git_dirty=true)."
                   if dirty else
                   "PROVENANCE: git state could not be determined (no git "
                   "binary / not a repository?) - provenance is unknowable.")
            if os.environ.get("WTW_REQUIRE_CLEAN"):
                raise RuntimeError(msg + "  (WTW_REQUIRE_CLEAN is set)")
            print(f"\n{'!' * 72}\n{msg}\n{'!' * 72}\n",
                  file=sys.stderr, flush=True)
        loadavg = None
        try:
            loadavg = list(os.getloadavg())
        except OSError:
            pass
        other_procs = []
        try:
            out = subprocess.run(
                ["ps", "-eo", "pid,pcpu,comm,args", "--no-headers"],
                capture_output=True, text=True, timeout=10).stdout
            me = os.getpid()
            for line in out.splitlines():
                parts = line.split(None, 3)
                if len(parts) < 4 or int(parts[0]) == me:
                    continue
                if "python" in parts[2] or "pytest" in parts[2]:
                    other_procs.append(
                        {"pid": int(parts[0]), "pcpu": float(parts[1]),
                         "cmd": parts[3][:160]})
        except Exception:
            pass
        dev = self.env.device
        cfg_json = json.dumps(dataclasses.asdict(self.env.cfg),
                              sort_keys=True, default=str)
        info = {
            "time": datetime.now().isoformat(timespec="seconds"),
            "argv": sys.argv,
            "git_sha": sha,
            "git_dirty": dirty,
            "seed": seed,
            "algo": self.algo,
            "num_envs": self.env.num_envs_global,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev)),
            "loadavg": loadavg,
            "ncpu": os.cpu_count(),
            "other_python_procs": other_procs,
            "config_hash": hashlib.sha256(
                cfg_json.encode()).hexdigest()[:12],
            "sim_params": dataclasses.asdict(self.env.sim_params),
            "runner_args": dataclasses.asdict(self.args),
            "ppo_args": dataclasses.asdict(self.ppo_args),
        }
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, "provenance.json"), "w") as f:
            json.dump(info, f, indent=1, default=str)

    def _write_chart_spec(self):
        """Dashboard chart spec in the run dir (the reference writes
        .charts.yml for ml_dash, scripts/train.py:227-253; any plotting
        frontend can consume it against metrics.jsonl)."""
        keys = ["train/episode/rew_total/mean",
                "train/episode/rew_tracking_lin_vel/mean",
                "train/episode/rew_tracking_contacts_shaped_force/mean",
                "train/episode/rew_action_smoothness_1/mean",
                "train/episode/rew_action_smoothness_2/mean",
                "train/episode/rew_tracking_contacts_shaped_vel/mean",
                "train/episode/rew_orientation_control/mean",
                "train/episode/rew_dof_pos/mean",
                "command_area_trot",
                "train/episode/mean_episode_length",
                "adaptation_loss"]
        lines = ["charts:"]
        for k in keys:
            lines += [f"- yKey: {k}", "  xKey: iterations"]
        lines += ["- type: video", '  glob: "videos/*.gif"', ""]
        os.makedirs(self.log_dir, exist_ok=True)
        with open(os.path.join(self.log_dir, ".charts.yml"), "w") as f:
            f.write("\n".join(lines))

    def dump_curriculum(self, it: int):
        """Dump the curriculum weight grids and per-bin episode task-reward
        means (window since the previous dump) — the analog of the
        reference's curriculum/distribution.pkl + curriculum/info.pkl
        appends (ppo_cse/__init__.py:193-202, legged_robot.py:229-232).
        The accumulators live on the device as monotonic sums inside
        CurriculumState; this drains deltas so the hot loop never resets
        them."""
        cur = {k: v.cpu().numpy()
               for k, v in self.env_state.curriculum._asdict().items()}
        if not hasattr(self, "_prev_bin_sums"):
            self._prev_bin_sums = np.zeros_like(cur["bin_task_sums"])
            self._prev_bin_counts = np.zeros_like(cur["bin_ep_counts"])
        d_sums = cur["bin_task_sums"] - self._prev_bin_sums
        d_counts = cur["bin_ep_counts"] - self._prev_bin_counts
        self._prev_bin_sums = cur["bin_task_sums"]
        self._prev_bin_counts = cur["bin_ep_counts"]
        means = d_sums / np.maximum(d_counts, 1.0)[..., None]
        out_dir = os.path.join(self.log_dir, "curriculum")
        os.makedirs(out_dir, exist_ok=True)
        np.savez(
            os.path.join(out_dir, f"distribution_{it:06d}.npz"),
            iteration=np.asarray(it),
            weights=cur["weights"],
            grid=self.env.curr_grid.grid,
            bin_task_reward_means=means,
            bin_episode_counts=d_counts,
            task_keys=np.asarray(curr.TASK_KEYS),
            categories=np.asarray(curr.CATEGORY_NAMES),
        )

    def log_video(self, it: int):
        """Render env 0 of the training env under the current student
        policy (`student_mean` for rma, `actor_mean` for cse) for
        `render_steps` control steps into `videos/<it>.gif` (reference
        log_video, ppo_cse/__init__.py:277-296).  It steps a throwaway
        copy of the env state with a generator of its own, so neither the
        training statistics nor the training generators' streams move.  On
        a mesh every rank steps its copy (the step's collectives need them
        all) and rank 0, which holds env 0, draws."""
        from ..utils.render import render_trajectory

        pol = self.train_state.policy
        state = self.env_state._replace(rng=make_generator(
            self._reset_seed + it, self.env.device))
        obs = self.obs_dict
        frames = []
        with torch.no_grad():
            for _ in range(self.args.render_steps):
                if self.algo == "rma":
                    actions = pol.student_mean(obs["obs"], obs["obs_history"])
                else:
                    actions = pol.actor_mean(obs["obs_history"])
                state, obs, _, _, _ = self.env.step(state, actions)
                frames.append(PhysicsState(*[x[0:1].clone()
                                             for x in state.phys]))
        if not self.rank0:
            return None
        out_dir = os.path.join(self.log_dir, "videos")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{it:05d}.gif")
        render_trajectory(self.env.model, frames, path,
                          fps=int(1 / self.env.dt), stride=2)
        print(f"saved video {path}", flush=True)
        return path

    # -- persistence ------------------------------------------------------
    # Path convention (the JAX runner's): *.pkl = a local pickle of numpy
    # arrays of the whole batch (utils/checkpoint.save, written by rank 0
    # from the gathered state); anything else = a shared-storage DIRECTORY
    # (utils/checkpoint.save_shared) that every rank writes its rows into
    # and any mesh resumes from — the analog of the reference Runner's
    # ml_logger-server resume (ppo_cse/__init__.py:76-91).
    def _state_tree(self, gathered: bool = False):
        """The checkpoint tree of the rank's state, or with `gathered` of
        the whole batch (every rank must call it then)."""
        ts = self.train_state
        env_state, obs = self.env_state, self.obs_dict
        if gathered:
            env_state, obs = mesh_mod.gather_env_state((env_state, obs),
                                                       self.rows)
        return {
            # the one layout holds either learner (convert.py)
            "train_state": dict(convert.train_state_to_numpy(ts),
                                rng=ts.rng.get_state().numpy()),
            "env_state": convert.env_state_to_numpy(env_state),
            "obs_dict": {k: v.cpu().numpy() for k, v in obs.items()},
        }

    def save(self, path: str):
        if not path.endswith(".pkl"):
            ckpt.save_shared(path, self._state_tree(), self.rows)
            return
        tree = self._state_tree(gathered=self.rows.distributed)
        if self.rank0:
            ckpt.save(path, tree)

    def load(self, path: str):
        dev = self.env.device
        if self.env_state is None:
            self.env_state, self.obs_dict = self.env.reset(
                make_generator(self._reset_seed, dev))
        if path.endswith(".pkl"):
            # the whole batch's pickle: this rank's rows of it
            tree = ckpt.load(path)
            loaded = ckpt.restore_like(self._state_tree(), dict(
                tree, **{k: mesh_mod.shard_env_state(tree[k], self.rows)
                         for k in ("env_state", "obs_dict")}))
        else:
            loaded = ckpt.load_shared(path, self._state_tree(), self.rows)
        tsd = loaded["train_state"]
        from_numpy = (convert.rma_train_state_from_numpy if self.algo == "rma"
                      else convert.train_state_from_numpy)
        self.train_state = from_numpy(
            tsd, convert.generator_from_state(tsd["rng"], dev),
            args=self.ppo_args, device=dev)
        esd = loaded["env_state"]
        self.env_state = convert.env_state_from_numpy(
            esd, convert.generator_from_state(esd["rng"], dev), device=dev)
        self.obs_dict = {k: torch.from_numpy(v).to(dev)
                         for k, v in loaded["obs_dict"].items()}

    def export_policy(self, dirpath: str):
        """Deployment artifact: flat npz of adaptation + actor weights
        (the analog of {adaptation_module,body}_latest.jit,
        ppo_cse/__init__.py:240-251), key for key the JAX package's.
        Written by rank 0 of a mesh.

        meta/variant records the actor input wiring — 'cse': actor(history
        + latent); 'rma': actor(obs + latent) (reference
        ppo/actor_critic.py:38-56)."""
        if not self.rank0:
            return
        os.makedirs(dirpath, exist_ok=True)
        pol = self.train_state.policy

        def arr(x):
            return x.detach().cpu().numpy()

        flat = {"meta/variant": np.asarray(self.algo)}
        for i, (w, b) in enumerate(zip(pol.adaptation.weights,
                                       pol.adaptation.biases)):
            flat[f"adaptation/w{i}"] = arr(w)
            flat[f"adaptation/b{i}"] = arr(b)
        for i, (w, b) in enumerate(zip(pol.actor.weights, pol.actor.biases)):
            flat[f"actor/w{i}"] = arr(w)
            flat[f"actor/b{i}"] = arr(b)
        flat["meta/n_adaptation"] = np.asarray(len(pol.adaptation.weights))
        flat["meta/n_actor"] = np.asarray(len(pol.actor.weights))
        flat["std"] = arr(pol.std)
        np.savez(os.path.join(dirpath, "policy_latest.npz"), **flat)
