"""Cross-engine oracle: the reference's PRETRAINED adaptation module against
this simulator, on one NVIDIA GPU.

Counterpart of the JAX package's scripts/validate_adaptation_cross_engine.py.
The reference checkout ships the pretrained run's adaptation module (the
committed resources/reference_policy/pretrain_v0_policy.npz; the actor body
is absent).  It was trained purely on IsaacGym/PhysX rollouts to regress the
true (friction, restitution) privileged state from the 30-step observation
history (reference go1_gym_learn/ppo_cse/ppo.py:163-192).

If this simulator's dynamics and observation pipeline match the reference's,
its trajectories must be in-distribution for that module: fed our obs
histories, it should recover our sim's true normalized friction /
restitution with an error comparable to its in-training test loss.  If our
physics or obs layout were off, a module trained on another engine's data
would regress garbage.

Protocol: N envs of `mob_train_cfg` (full MoB domain randomization) on the
device, a policy this package's runner exported driving them; after a
warmup (so the 30 x 70 history fills with steady-state gait), collect
(obs_history, true priv obs) pairs every 10 steps and score the reference
module and the policy's own module (numpy, `mlp_elu`) on MSE and per-target
correlation, beside two controls.

Usage: python -m walk_these_ways_tpu_torch.scripts.validate_adaptation_cross_engine
           [--policy runs/latest/checkpoints/policy_latest.npz]
           [--reference resources/reference_policy/pretrain_v0_policy.npz]
           [--num-envs 256] [--warmup-steps 150] [--collect-steps 200]
           [--device cuda]

Runs on a CUDA device; without one it raises unless `--device cpu` is
asked for.
"""
import argparse
import json
import os

import numpy as np


def mlp_elu(z, prefix, n, x):
    for i in range(n):
        x = x @ z[f"{prefix}/w{i}"] + z[f"{prefix}/b{i}"]
        if i < n - 1:
            x = np.where(x > 0, x, np.expm1(np.minimum(x, 0)))
    return x


def main(policy_path, reference_path, num_envs, warmup_steps, collect_steps,
         out_path, device="cuda", save_data=None):
    import torch

    from walk_these_ways_tpu_torch.envs.go1_env import (LeggedRobotEnv,
                                                        make_generator)
    from walk_these_ways_tpu_torch.go1_config import mob_train_cfg
    from walk_these_ways_tpu_torch.scripts.play import load_policy

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the PyTorch port runs this check on a CUDA "
                               "device: torch.cuda.is_available() is False "
                               "(pass device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    env = LeggedRobotEnv(mob_train_cfg(num_envs=num_envs), device=dev)
    pol = dict(np.load(policy_path))
    ref = dict(np.load(reference_path))
    policy = load_policy(policy_path, device=dev)

    state, obs = env.reset(make_generator(7, dev))
    for _ in range(warmup_steps):
        state, obs, _, _, _ = env.step(state, policy(obs))

    hists, privs = [], []
    for t in range(collect_steps):
        state, obs, _, _, _ = env.step(state, policy(obs))
        if (t + 1) % 10 == 0:  # decorrelate samples
            hists.append(obs["obs_history"].cpu().numpy())
            privs.append(obs["privileged_obs"].cpu().numpy())
    H = np.concatenate(hists, axis=0)
    P = np.concatenate(privs, axis=0)
    if save_data:
        np.savez_compressed(save_data, H=H, P=P)

    pred_ref = mlp_elu(ref, "adaptation", 3, H)
    pred_ours = mlp_elu(pol, "adaptation", 3, H)

    def score(pred):
        mse = float(np.mean(np.square(pred - P)))
        corr = [float(np.corrcoef(pred[:, j], P[:, j])[0, 1])
                for j in range(P.shape[1])]
        # affine-calibrated R^2 per dim: how much target variance ANY
        # linear readout of this prediction explains — separates "module
        # carries signal with a scale/offset mismatch" from "no signal"
        r2 = [c ** 2 for c in corr]
        stats = {"pred_mean": pred.mean(0).tolist(),
                 "pred_std": pred.std(0).tolist()}
        return mse, corr, r2, stats

    mse_ref, corr_ref, r2_ref, st_ref = score(pred_ref)
    mse_ours, corr_ours, r2_ours, st_ours = score(pred_ours)

    # Controls for the in-distribution claim: if our histories were
    # out-of-distribution (wrong layout / scales / dynamics), the reference
    # module's outputs blow up instead of landing in its target range.
    rng = np.random.RandomState(0)
    Hs = H.copy()
    for row in Hs:
        rng.shuffle(row)
    Hg = H.mean(0) + H.std(0) * rng.randn(*H.shape).astype(np.float32)
    controls = {
        name: {"pred_mean": p.mean(0).tolist(), "pred_std": p.std(0).tolist()}
        for name, p in [("feature_shuffled", mlp_elu(ref, "adaptation", 3, Hs)),
                        ("marginal_gaussian",
                         mlp_elu(ref, "adaptation", 3, Hg))]
    }
    # baseline: predicting the overall mean (what a module regressing
    # garbage would converge to)
    mse_null = float(np.mean(np.square(P - P.mean(axis=0, keepdims=True))))

    result = {
        "samples": int(H.shape[0]),
        "mse_reference_module": mse_ref,
        "mse_our_module": mse_ours,
        "mse_predict_mean_baseline": mse_null,
        "corr_reference_module": {"friction": corr_ref[0],
                                  "restitution": corr_ref[1]},
        "corr_our_module": {"friction": corr_ours[0],
                            "restitution": corr_ours[1]},
        "r2_reference_module": r2_ref,
        "r2_our_module": r2_ours,
        "target_mean": P.mean(0).tolist(),
        "target_std": P.std(0).tolist(),
        "pred_stats_reference": st_ref,
        "pred_stats_ours": st_ours,
        "controls_reference_module": controls,
        "policy": policy_path,
        "reference": reference_path,
        "num_envs": num_envs,
        "warmup_steps": warmup_steps,
        "collect_steps": collect_steps,
        "device": str(dev),
    }
    print(json.dumps(result, indent=2))
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
        print(f"wrote {out_path}")
    return result


def cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy",
                    default="runs/latest/checkpoints/policy_latest.npz")
    ap.add_argument("--reference",
                    default="resources/reference_policy/pretrain_v0_policy.npz")
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--warmup-steps", type=int, default=150)
    ap.add_argument("--collect-steps", type=int, default=200)
    ap.add_argument("--out",
                    default="runs/cross_engine_validation/adaptation.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save-data", default=None)
    a = ap.parse_args(argv)
    if not os.path.exists(a.policy):
        # run-dir checkpoints are not committed: train and export one first
        ap.error(
            f"policy artifact not found: {a.policy}\n"
            "Exported policies live in <run_dir>/checkpoints/"
            "policy_latest.npz and are not committed to git: train one "
            "(python -m walk_these_ways_tpu_torch.scripts.train) or pass "
            "--policy to an existing export.")
    return main(a.policy, a.reference, a.num_envs, a.warmup_steps,
                a.collect_steps, a.out, device=a.device,
                save_data=a.save_data)


if __name__ == "__main__":
    cli()
