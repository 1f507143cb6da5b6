"""Train the full walk-these-ways MoB policy on one NVIDIA GPU.

Counterpart of the JAX package's scripts/train.py (reference
scripts/train.py:1-256, train_go1): the config is the `mob_train_cfg` preset
(with `--terrain rough`, `rough_train_cfg`: the same stack on a rough
heightfield; with `--config small`, `small_train_cfg`: flat, no DR, P
control), the trainer is the PPO-CSE loop of learn/runner.py (with `--algo
rma`, the teacher-student trainer of learn/ppo_rma.py), logging goes to a
local JSONL run dir.  Runs on the GPU only: without a CUDA device it raises.

Usage: python -m walk_these_ways_tpu_torch.scripts.train
           [--num-envs 4000] [--iterations 1500] [--exact]
           [--terrain rough] [--algo cse|rma] [--resume CKPT | DIR]
           [--num-eval-envs 400 [--eval-dr rand_large]
            [--eval-terrain rough] [--eval-expert]]
           [--mesh] [--shared-ckpt DIR]
       torchrun --nproc-per-node N -m walk_these_ways_tpu_torch.scripts.train
           --mesh ...

`--num-eval-envs` appends eval envs after the train envs (the reference's
train/eval split): they act deterministically, stay out of PPO and are
logged under `eval/episode/*`; `--eval-dr` puts them under a DR preset of
learn/eval_metrics.DR_SETTINGS, `--eval-terrain` on terrain rows of their
own, `--eval-expert` hands them to the teacher.

`--mesh` joins the process group that the launcher's variables describe
(`torchrun` sets them; NCCL when every rank has a card of its own, gloo
when ranks share one) and splits the envs over its ranks (env-axis data
parallel, parallel/mesh.py); without the launcher it is one process, a
mesh of one rank.  `--multihost` is another name for `--mesh`.
`--num-envs` (and
`--num-eval-envs`) count the whole batch and must divide over the ranks.
`--shared-ckpt DIR` commits the train state to a shared-storage directory
at every save interval and at the end, which every rank writes its rows
into; `--resume DIR` resumes from one on any number of ranks.  `train_go1`
runs on a CUDA device; without one it raises unless `device="cpu"` is
asked for.
"""
import argparse
import dataclasses
import os
from datetime import datetime


def train_go1(num_envs: int, iterations: int, log_dir: str, seed: int,
              num_eval_envs: int = 0, eval_expert: bool = False,
              algo: str = "cse", use_mesh: bool = False,
              exact: bool = False,
              terrain: str = "flat", warm_start: bool | None = None,
              warm_iters: int | None = None, resume: str | None = None,
              eval_dr: str | None = None, eval_terrain: str | None = None,
              shared_ckpt: str | None = None, config: str = "mob",
              device="cuda"):
    import torch

    from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
    from walk_these_ways_tpu_torch.go1_config import (mob_train_cfg,
                                                      rough_train_cfg,
                                                      small_train_cfg)
    from walk_these_ways_tpu_torch.learn.eval_metrics import DR_SETTINGS
    from walk_these_ways_tpu_torch.learn.runner import Runner, RunnerArgs
    from walk_these_ways_tpu_torch.parallel import mesh as mesh_mod
    from walk_these_ways_tpu_torch.utils import checkpoint as ckpt

    if shared_ckpt is not None:
        shared_ckpt = ckpt._shared_path(shared_ckpt)
    if terrain == "rough" and config == "small":
        raise ValueError("--terrain rough runs rough_train_cfg; there is no "
                         "small configuration on rough terrain")
    if not num_eval_envs and (eval_expert or eval_dr or eval_terrain):
        raise ValueError("--eval-expert, --eval-dr and --eval-terrain need "
                         "--num-eval-envs")
    if eval_dr is not None and eval_dr not in DR_SETTINGS:
        raise ValueError(f"--eval-dr {eval_dr!r}: not one of "
                         f"{sorted(DR_SETTINGS)}")

    if terrain == "rough":
        cfg_fn = rough_train_cfg
    else:
        cfg_fn = small_train_cfg if config == "small" else mob_train_cfg
    cfg = cfg_fn(num_envs=num_envs)
    eval_cfg = cfg_fn(num_envs=num_eval_envs) if num_eval_envs else None
    if eval_cfg is not None and eval_dr is not None:
        # the eval slice under a DR sweep preset (reference eval_metrics
        # DR_SETTINGS applied to the eval env while training continues)
        eval_cfg = dataclasses.replace(eval_cfg,
                                       domain_rand=DR_SETTINGS[eval_dr])
    if eval_cfg is not None and eval_terrain is not None:
        # the eval slice on terrain rows of its own, appended to the train
        # heightfield (reference utils/terrain.py:12-30)
        ev_fn = rough_train_cfg if eval_terrain == "rough" else mob_train_cfg
        eval_cfg = dataclasses.replace(
            eval_cfg, terrain=ev_fn(num_envs=num_eval_envs).terrain)
    sim = cfg.sim
    if warm_start is not None:
        sim = dataclasses.replace(sim, contact_warm_start=warm_start)
    if warm_iters is not None:
        sim = dataclasses.replace(sim, num_contact_iters_warm=warm_iters)
    if exact:
        # exact per-substep dynamics (no matrix reuse): the cache is rebuilt
        # inside the control-step kernel before every substep
        sim = dataclasses.replace(sim, reuse_matrices=False)
    cfg = dataclasses.replace(cfg, sim=sim)
    if eval_cfg is not None:
        eval_cfg = dataclasses.replace(eval_cfg, sim=sim)
    dev = torch.device(device)
    mesh = None
    if use_mesh:
        # join the launcher's process group (none without the launcher),
        # so the mesh spans every rank, on the rank's card (make_mesh
        # raises without CUDA unless the CPU is asked for)
        mesh_mod.maybe_init_distributed(device=dev)
        mesh = mesh_mod.make_mesh(device=dev)
        if num_envs % mesh.world_size or num_eval_envs % mesh.world_size:
            raise ValueError(f"num_envs ({num_envs}) and num_eval_envs "
                             f"({num_eval_envs}) must divide over the "
                             f"{mesh.world_size} ranks")
        print(f"mesh: {mesh!r}, {num_envs // mesh.world_size} train envs "
              "a rank", flush=True)
        dev = mesh.device
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the PyTorch port trains on a CUDA device: "
                               "torch.cuda.is_available() is False (pass "
                               "device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env = LeggedRobotEnv(cfg, eval_cfg=eval_cfg, device=dev, mesh=mesh)
    runner = Runner(env, log_dir=log_dir, seed=seed,
                    args=RunnerArgs(max_iterations=iterations,
                                    eval_expert=eval_expert,
                                    resume=resume is not None,
                                    resume_path=resume,
                                    shared_ckpt_dir=shared_ckpt),
                    algo=algo, mesh=mesh)
    runner.learn(num_learning_iterations=iterations,
                 init_at_random_ep_len=True)
    return runner


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--num-envs", type=int, default=4000)
    p.add_argument("--iterations", type=int, default=1500)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-dir", type=str, default=None)
    p.add_argument("--config", choices=["mob", "small"], default="mob",
                   help="mob = go1_config.mob_train_cfg (default); small = "
                        "small_train_cfg (flat, no DR, P control)")
    p.add_argument("--num-eval-envs", type=int, default=0,
                   help="extra eval envs (deterministic policy, excluded "
                        "from PPO; reference train/eval split)")
    p.add_argument("--eval-expert", action="store_true",
                   help="eval envs use the teacher head")
    p.add_argument("--algo", choices=["cse", "rma"], default="cse",
                   help="cse = concurrent state estimation (default); "
                        "rma = teacher-student with an env-factor encoder "
                        "(learn/ppo_rma.py)")
    p.add_argument("--mesh", "--multihost", dest="mesh", action="store_true",
                   help="join the process group of the launcher's variables "
                        "(RANK, WORLD_SIZE, MASTER_ADDR, ... as torchrun "
                        "sets them) and split the envs over its ranks "
                        "(env-axis data parallel; one process: one rank)")
    p.add_argument("--exact", action="store_true",
                   help="exact per-substep dynamics (reuse_matrices off)")
    p.add_argument("--terrain", choices=["flat", "rough"], default="flat",
                   help="flat = MoB boxes tiles (default); rough = "
                        "go1_config.rough_train_cfg (rough heightfield)")
    p.add_argument("--warm-start", dest="warm_start", action="store_true",
                   default=None,
                   help="warm-start contact impulses across decimation "
                        "substeps (control-step route)")
    p.add_argument("--no-warm-start", dest="warm_start",
                   action="store_false",
                   help="force cold-start contact solves")
    p.add_argument("--warm-iters", type=int, default=None,
                   help="warm-started solver iterations per substep "
                        "(SimCfg.num_contact_iters_warm)")
    p.add_argument("--eval-dr", type=str, default=None,
                   help="DR preset for the eval slice "
                        "(learn.eval_metrics.DR_SETTINGS key, e.g. "
                        "static_high); requires --num-eval-envs")
    p.add_argument("--eval-terrain", type=str, default=None,
                   choices=["flat", "rough"],
                   help="give the eval slice its own terrain rows "
                        "(appended after the train rows)")
    p.add_argument("--resume", type=str, default=None, metavar="CKPT",
                   help="checkpoint to resume from: a train_state_*.pkl "
                        "(local pickle) or a shared-storage directory (any "
                        "number of ranks).  Restores the full train state "
                        "incl. env/curriculum/generator states; training "
                        "continues from the stored iteration count")
    p.add_argument("--shared-ckpt", type=str, default=None, metavar="DIR",
                   help="also commit the train state to this shared-storage "
                        "directory at every save interval and at the end, "
                        "as a common resume point for every rank")
    a = p.parse_args(argv)
    log_dir = a.log_dir or os.path.join(
        "runs", "gait-conditioned-agility",
        datetime.now().strftime("%Y-%m-%d/train/%H%M%S"))
    train_go1(a.num_envs, a.iterations, log_dir, a.seed,
              num_eval_envs=a.num_eval_envs, eval_expert=a.eval_expert,
              algo=a.algo, use_mesh=a.mesh,
              exact=a.exact, terrain=a.terrain, warm_start=a.warm_start,
              warm_iters=a.warm_iters, resume=a.resume,
              eval_dr=a.eval_dr, eval_terrain=a.eval_terrain,
              shared_ckpt=a.shared_ckpt, config=a.config)


if __name__ == "__main__":
    main()
