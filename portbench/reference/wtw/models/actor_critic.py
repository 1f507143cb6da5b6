"""Frozen copy of walk_these_ways_tpu_torch/models/actor_critic.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Actor-critic for concurrent state estimation (ppo_cse variant).

Counterpart of the reference ActorCritic (reference:
go1_gym_learn/ppo_cse/actor_critic.py:19-147):

- adaptation_module: obs_history (2100) -> [256, 128] -> num_privileged (2)
- actor_body:  obs_history + latent (2102) -> [512, 256, 128] -> 12
- critic_body: obs_history + priv   (2102) -> [512, 256, 128] -> 1
- learned state-independent log-free std (init 1.0), Normal policy.

An `nn.Module`; weights are stored (in, out) and applied as `x @ w + b`, the
layout of the JAX package's parameter tree and of the committed .npz files,
so arrays carry across without a transpose.  Init matches torch's Linear
default (U[-1/sqrt(fan_in), 1/sqrt(fan_in)] for both W and b).  Activation:
ELU.  The products are plain large matrix products and go to `torch.matmul`
in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AC_Args:
    """reference actor_critic.py:7-17"""
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    adaptation_module_branch_hidden_dims: Tuple[int, ...] = (256, 128)


class MLP(nn.Module):
    """ELU MLP with (in, out) weights: x @ w + b."""

    def __init__(self, sizes: Sequence[int], generator=None, device="cuda"):
        super().__init__()
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for i in range(len(sizes) - 1):
            lim = 1.0 / math.sqrt(sizes[i])
            w = (torch.rand((sizes[i], sizes[i + 1]), generator=generator,
                            device=device) * 2 - 1) * lim
            b = (torch.rand((sizes[i + 1],), generator=generator,
                            device=device) * 2 - 1) * lim
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.weights)
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            x = x @ w + b
            if i < n - 1:
                x = nn.functional.elu(x)
        return x


class ActorCritic(nn.Module):
    def __init__(self, num_obs: int, num_privileged_obs: int,
                 num_obs_history: int, num_actions: int,
                 args: AC_Args = AC_Args(), generator=None, device="cuda"):
        """`generator` (on `device`) seeds the initial weights."""
        super().__init__()
        self.num_obs = num_obs
        self.num_privileged_obs = num_privileged_obs
        self.num_obs_history = num_obs_history
        self.num_actions = num_actions
        self.adaptation = MLP(
            [num_obs_history, *args.adaptation_module_branch_hidden_dims,
             num_privileged_obs], generator, device)
        self.actor = MLP(
            [num_privileged_obs + num_obs_history, *args.actor_hidden_dims,
             num_actions], generator, device)
        self.critic = MLP(
            [num_privileged_obs + num_obs_history, *args.critic_hidden_dims,
             1], generator, device)
        self.std = nn.Parameter(
            args.init_noise_std * torch.ones(num_actions, device=device))

    # -- policy heads (reference actor_critic.py:113-147) -------------------
    def adaptation_forward(self, obs_history):
        return self.adaptation(obs_history)

    def actor_mean(self, obs_history):
        """Student: history -> latent -> action mean."""
        latent = self.adaptation_forward(obs_history)
        return self.actor(torch.cat([obs_history, latent], dim=-1))


    def evaluate(self, obs_history, privileged_obs):
        v = self.critic(torch.cat([obs_history, privileged_obs], dim=-1))
        return v[..., 0]

    def sample_actions(self, obs_history, generator: torch.Generator,
                       rows=None):
        """Returns (actions, log_prob, mean, std); the noise comes from the
        explicit `generator` (on the module's device).  With `rows` = (n,
        slice) the noise is drawn for n envs and the slice's rows used (a
        rank of a data-parallel run, parallel/mesh.EnvRows.train_draw)."""
        mean = self.actor_mean(obs_history)
        std = self.std.expand_as(mean)
        eps = noise_like(mean, generator, rows)
        actions = mean + std * eps
        logp = gaussian_log_prob(actions, mean, std)
        return actions, logp, mean, std

    forward = actor_mean


def gaussian_log_prob(x, mean, std):
    var = torch.square(std)
    lp = -0.5 * torch.square(x - mean) / var - torch.log(std) \
        - 0.5 * math.log(2 * math.pi)
    return torch.sum(lp, dim=-1)


def noise_like(mean, generator, rows=None):
    """Standard normal noise of `mean`'s shape: the rows `slice` of a draw
    over n rows, `rows` = (n, slice) (default: all of `mean`'s)."""
    n, keep = rows if rows is not None else (mean.shape[0], slice(None))
    return torch.randn((n,) + tuple(mean.shape[1:]), generator=generator,
                       device=mean.device)[keep]


def gaussian_entropy(std):
    return torch.sum(0.5 + 0.5 * math.log(2 * math.pi) + torch.log(std),
                     dim=-1)
