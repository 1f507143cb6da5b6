"""Policy evaluation rollout (sim "play") on one NVIDIA GPU.

Counterpart of the JAX package's scripts/play.py (reference
scripts/play.py:17-162): load an exported policy artifact
(`policy_latest.npz`, written by `learn/runner.Runner.export_policy`), run
1 env with domain randomisation and noise off under a fixed trot command at
1.5 m/s for 250 steps, and report tracking statistics.

Usage: python -m walk_these_ways_tpu_torch.scripts.play
           [--policy runs/latest/checkpoints/policy_latest.npz]
           [--steps 250] [--plot] [--plot-path PNG] [--video GIF]

`--video` records env 0's PhysicsState each step and draws its skeleton to
a video (utils/render.py; matplotlib and imageio).  `play_go1` runs on a
CUDA device; without one it raises unless `device="cpu"` is asked for.
"""
import argparse
import dataclasses
import os


def load_policy(path, device="cuda"):
    """Student policy from the flat npz export (Runner.export_policy):
    obs_dict -> actions.  The returned callable also has the student's
    `adaptation_forward(obs_history)` and, for a cse export,
    `actor_mean(obs_history)`, which learn/eval_metrics.py takes.

    Variant-aware (meta/variant): 'cse' actor consumes obs_history+latent,
    'rma' consumes obs+latent; artifacts without meta keys are cse."""
    import numpy as np
    import torch

    from walk_these_ways_tpu_torch.models.actor_critic import MLP

    z = np.load(path)
    variant = str(z["meta/variant"]) if "meta/variant" in z else "cse"
    n_adapt = int(z["meta/n_adaptation"]) if "meta/n_adaptation" in z else 3
    n_actor = int(z["meta/n_actor"]) if "meta/n_actor" in z else 4

    def mlp(prefix, n):
        ws = [z[f"{prefix}/w{i}"] for i in range(n)]
        bs = [z[f"{prefix}/b{i}"] for i in range(n)]
        net = MLP([ws[0].shape[0]] + [w.shape[1] for w in ws], device=device)
        with torch.no_grad():
            for p, x in zip(list(net.weights) + list(net.biases), ws + bs):
                p.copy_(torch.as_tensor(x, dtype=torch.float32))
        return net

    adaptation = mlp("adaptation", n_adapt)
    actor = mlp("actor", n_actor)

    def policy(obs_dict):
        with torch.no_grad():
            hist = obs_dict["obs_history"]
            latent = adaptation(hist)
            body_in = obs_dict["obs"] if variant == "rma" else hist
            return actor(torch.cat([body_in, latent], dim=-1))

    policy.adaptation_forward = adaptation
    if variant == "cse":
        policy.actor_mean = lambda hist: policy({"obs_history": hist})
    return policy


def play_go1(policy_path: str, steps: int = 250, plot: bool = False,
             plot_path: str = None, video_path: str = None,
             device="cuda"):
    import numpy as np
    import torch

    from walk_these_ways_tpu_torch.config import DomainRandCfg, NoiseCfg
    from walk_these_ways_tpu_torch.envs.go1_env import (LeggedRobotEnv,
                                                        make_generator)
    from walk_these_ways_tpu_torch.go1_config import mob_train_cfg
    from walk_these_ways_tpu_torch.ops import quat as qops
    from walk_these_ways_tpu_torch.physics.engine import PhysicsState

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the PyTorch port plays back on a CUDA device: "
                               "torch.cuda.is_available() is False (pass "
                               "device='cpu' to run on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = mob_train_cfg(num_envs=1)
    # DR off, noise off (reference play.py:46-61)
    cfg = dataclasses.replace(cfg, domain_rand=DomainRandCfg(
        randomize_friction=False, randomize_restitution=False,
        randomize_base_mass=False, randomize_com_displacement=False,
        randomize_motor_strength=False, randomize_motor_offset=False,
        randomize_gravity=False, push_robots=False,
        randomize_lag_timesteps=True, lag_timesteps=6,
        randomize_Kp_factor=False, randomize_Kd_factor=False),
        noise=NoiseCfg(add_noise=False))
    env = LeggedRobotEnv(cfg, device=dev)
    policy = load_policy(policy_path, device=dev)

    # fixed trot command @ 1.5 m/s (reference play.py:101-136)
    gaits = {"pronk": [0, 0, 0], "trot": [0.5, 0, 0],
             "pace": [0, 0.5, 0], "bound": [0, 0, 0.5]}
    cmd = np.zeros(15, np.float32)
    cmd[0] = 1.5                  # x vel
    cmd[3] = 0.0                  # body height
    cmd[4] = 3.0                  # frequency
    cmd[5:8] = gaits["trot"]
    cmd[8] = 0.5                  # duration
    cmd[9] = 0.08                 # footswing height
    cmd[12] = 0.25                # stance width
    cmd_t = torch.as_tensor(cmd, device=dev)[None, :]

    state, obs = env.reset(make_generator(42, dev))
    xs, vxs, qs, phys_frames = [], [], [], []
    for _ in range(steps):
        state = state._replace(commands=cmd_t)
        state, obs, rew, done, info = env.step(state, policy(obs))
        v_body = qops.quat_rotate_inverse(state.phys.base_quat,
                                          state.phys.base_lin_vel)
        vxs.append(float(v_body[0, 0]))
        xs.append(float(state.phys.base_pos[0, 0]))
        qs.append(state.phys.q[0].cpu().numpy())
        if video_path:
            phys_frames.append(PhysicsState(*[x[0:1].clone()
                                              for x in state.phys]))
    vxs = np.array(vxs)
    qs = np.stack(qs)
    print(f"mean body-frame vx over rollout: {vxs.mean():.3f} m/s "
          "(target 1.5)")
    print(f"distance covered: {abs(xs[-1] - xs[0]):.2f} m along world-x "
          f"in {steps * env.dt:.1f} s (spawn yaw is randomized)")
    if video_path:
        # qualitative gait-inspection artifact (the reference captures its
        # videos with IsaacGym's camera, legged_robot.py:1592-1673)
        from walk_these_ways_tpu_torch.utils.render import render_trajectory
        render_trajectory(env.model, phys_frames, video_path,
                          fps=int(1 / env.dt), stride=2)
        print(f"saved gait video to {video_path}")
    if plot:
        # measured-vs-desired velocity + joint positions figure
        # (reference play.py:140-157); matplotlib only when asked for
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
        t = np.linspace(0, steps * env.dt, steps)
        fig, axs = plt.subplots(2, 1, figsize=(12, 5))
        axs[0].plot(t, vxs, color="black", linestyle="-", label="Measured")
        axs[0].plot(t, np.full(steps, cmd[0]), color="black",
                    linestyle="--", label="Desired")
        axs[0].legend()
        axs[0].set_title("Forward Linear Velocity")
        axs[0].set_xlabel("Time (s)")
        axs[0].set_ylabel("Velocity (m/s)")
        axs[1].plot(t, qs, linestyle="-")
        axs[1].set_title("Joint Positions")
        axs[1].set_xlabel("Time (s)")
        axs[1].set_ylabel("Joint Position (rad)")
        plt.tight_layout()
        out = plot_path or os.path.join(
            os.path.dirname(policy_path) or ".", "play_rollout.png")
        plt.savefig(out, dpi=120)
        print(f"saved rollout figure to {out}")
    return vxs


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--policy", type=str,
                   default="runs/latest/checkpoints/policy_latest.npz")
    p.add_argument("--steps", type=int, default=250)
    p.add_argument("--plot", action="store_true",
                   help="save the reference play.py velocity/joint figure")
    p.add_argument("--plot-path", type=str, default=None)
    p.add_argument("--video", type=str, default=None, metavar="PATH",
                   help="render the rollout to a skeleton video "
                        "(.gif / .mp4)")
    a = p.parse_args(argv)
    return play_go1(a.policy, a.steps, plot=a.plot, plot_path=a.plot_path,
                    video_path=a.video)


if __name__ == "__main__":
    main()
