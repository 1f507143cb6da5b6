"""Offline trajectory renderer (video logging).

Counterpart of the JAX package's utils/render.py.  The reference records
per-env-0 camera videos through IsaacGym's renderer (reference:
go1_gym/envs/base/legged_robot.py:1592-1673 `_render_headless`,
go1_gym_learn/ppo_cse/__init__.py:277-296 `log_video`).  There is no GPU
renderer here: the robot's skeleton (leg chains + feet) comes from
`physics/engine.forward_kinematics`, run on the device the recorded
PhysicsStates live on, and is drawn with matplotlib and encoded with imageio,
both imported only when a video is drawn.

Usage:
    frames = [state.phys[0:1] after each control step]
    render_trajectory(model, frames, "rollout.gif", fps=50)
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def _skeleton_points(model, phys, env_idx: int = 0):
    """Joint-chain world positions (nb, 3) and feet (4, 3), as numpy, of one
    env of a PhysicsState on any device; FK runs on that device."""
    from ..physics import engine as eng

    one = type(phys)(*[x[env_idx:env_idx + 1] for x in phys])
    with torch.no_grad():
        frames = eng.forward_kinematics(model, one)
    p = frames.p[0].cpu().numpy()          # (nb, 3) joint origins
    R = frames.R[0].cpu().numpy()
    feet = p[model.foot_body] + np.einsum(
        "fij,fj->fi", R[model.foot_body], model.foot_offset)
    return p, feet


def render_trajectory(model, phys_states: Sequence, out_path: str,
                      fps: int = 50, env_idx: int = 0, stride: int = 1):
    """Render a list of PhysicsStates to a video file (.mp4 / .gif)."""
    import imageio
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    imgs: List[np.ndarray] = []
    for t in range(0, len(phys_states), stride):
        p, feet = _skeleton_points(model, phys_states[t], env_idx)
        base = p[0]
        fig = plt.figure(figsize=(6, 4), dpi=90)
        ax = fig.add_subplot(111, projection="3d")
        # leg chains: base -> hip -> thigh -> calf -> foot
        for leg in range(4):
            hip, thigh, calf = 1 + 3 * leg, 2 + 3 * leg, 3 + 3 * leg
            chain = np.stack([base, p[hip], p[thigh], p[calf], feet[leg]])
            ax.plot(chain[:, 0], chain[:, 1], chain[:, 2], "-o",
                    markersize=2.5, linewidth=1.5)
        ax.scatter(*base, s=40, c="k")
        # ground plane reference
        gx = np.linspace(base[0] - 0.6, base[0] + 0.6, 2)
        gy = np.linspace(base[1] - 0.6, base[1] + 0.6, 2)
        GX, GY = np.meshgrid(gx, gy)
        ax.plot_surface(GX, GY, np.zeros_like(GX), alpha=0.15, color="gray")
        ax.set_xlim(base[0] - 0.6, base[0] + 0.6)
        ax.set_ylim(base[1] - 0.6, base[1] + 0.6)
        ax.set_zlim(0, 0.8)
        ax.set_box_aspect((1, 1, 0.66))
        ax.view_init(elev=12, azim=-60)
        ax.set_axis_off()
        fig.tight_layout(pad=0)
        fig.canvas.draw()
        imgs.append(np.asarray(fig.canvas.buffer_rgba())[..., :3])
        plt.close(fig)
    imageio.mimsave(out_path, imgs, fps=fps // stride)
    return out_path
