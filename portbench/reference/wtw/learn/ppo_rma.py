"""Frozen copy of walk_these_ways_tpu_torch/learn/ppo_rma.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

RMA-style teacher-student PPO (the reference's ``ppo/`` variant) on PyTorch.

Counterpart of the JAX package's learn/ppo_rma.py (reference:
go1_gym_learn/ppo/actor_critic.py:38-56 — an explicit env-factor encoder
priv_obs -> latent feeding the actor on the CURRENT obs (not the history);
ppo/ppo.py:64-65 — the policy acts on obs + encoder latent;
ppo/ppo.py:150-170 — the adaptation module distills the encoder's latent
from the obs history with an MSE loss).  learn/ppo.py (ppo_cse) is the
default trainer; this one is `Runner(algo="rma")` / `scripts.train --algo
rma`.  It shares `compute_gae`, the PPO loss and the main Adam step
(`ppo_loss`, `main_step`: the KL-adaptive learning rate, the global-norm
clip) with learn/ppo.py; the differences are the policy and the actor /
adaptation targets.

Parity notes (semantics matched to the JAX package, file:line there):
- rollout (ppo_rma.py:113-141): the train envs sample the teacher on
  (obs, priv_obs); the eval envs act with `student_mean` on the obs
  history, or with the teacher's mean when `eval_expert`; rewards are
  bootstrapped on time-outs as rew + gamma * v * time_out
- one permutation of the T*N batch, reused by every epoch (:175-177)
- each minibatch takes the main Adam step first; the adaptation MSE step
  follows, its target the encoder as it stands AFTER that step (:214-229)
- the main Adam spans every parameter, the adaptation module included, as
  optax's does: the PPO loss never reaches the adaptation module, so
  `ppo.main_step` sets its gradients to zeros (not left None, which torch's
  Adam would skip) and its moments and step count advance as the JAX
  optimizer's do
- `adaptation_test_loss` is `adaptation_loss`: the RMA update has no 80/20
  split (:239-244)

Data parallel over an env mesh as learn/ppo.py is (its module docstring):
the teacher's noise over the whole batch, the global permutation's
minibatches, the losses' parts summed over the ranks with the gradients.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ..models import actor_critic as ac
from ..parallel import mesh as mesh_mod
from . import ppo


@dataclasses.dataclass(frozen=True)
class RMA_Args:
    """reference ppo/actor_critic.py:7-24"""
    init_noise_std: float = 1.0
    actor_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    critic_hidden_dims: Tuple[int, ...] = (512, 256, 128)
    encoder_hidden_dims: Tuple[int, ...] = (256, 128)
    adaptation_hidden_dims: Tuple[int, ...] = (256, 32)
    latent_dim: int = 18


class RMAPolicy(nn.Module):
    """encoder: priv_obs -> latent; adaptation: obs_history -> latent
    (distilled); actor, critic: obs + latent; a learned std.  The four
    MLPs are `models/actor_critic.MLP` (ELU, (in, out) weights)."""

    def __init__(self, num_obs: int, num_privileged_obs: int,
                 num_obs_history: int, num_actions: int,
                 args: RMA_Args = RMA_Args(), generator=None, device="cuda"):
        """`generator` (on `device`) seeds the initial weights."""
        super().__init__()
        self.num_obs = num_obs
        self.num_privileged_obs = num_privileged_obs
        self.num_obs_history = num_obs_history
        self.num_actions = num_actions
        latent = args.latent_dim
        self.encoder = ac.MLP(
            [num_privileged_obs, *args.encoder_hidden_dims, latent],
            generator, device)
        self.adaptation = ac.MLP(
            [num_obs_history, *args.adaptation_hidden_dims, latent],
            generator, device)
        self.actor = ac.MLP([num_obs + latent, *args.actor_hidden_dims,
                             num_actions], generator, device)
        self.critic = ac.MLP([num_obs + latent, *args.critic_hidden_dims, 1],
                             generator, device)
        self.std = nn.Parameter(
            args.init_noise_std * torch.ones(num_actions, device=device))

    def teacher_mean(self, obs, privileged_obs):
        """(action mean, latent) of the teacher: encoder(priv_obs)."""
        latent = self.encoder(privileged_obs)
        return self.actor(torch.cat([obs, latent], dim=-1)), latent


    def evaluate(self, obs, privileged_obs):
        latent = self.encoder(privileged_obs)
        return self.critic(torch.cat([obs, latent], dim=-1))[..., 0]

    def sample_actions(self, obs, privileged_obs, generator: torch.Generator,
                       rows=None):
        """Returns (actions, log_prob, mean, std) of the teacher; the noise
        comes from the explicit `generator` (on the module's device), `rows`
        as in ActorCritic.sample_actions."""
        mean, _ = self.teacher_mean(obs, privileged_obs)
        std = self.std.expand_as(mean)
        eps = ac.noise_like(mean, generator, rows)
        actions = mean + std * eps
        return actions, ac.gaussian_log_prob(actions, mean, std), mean, std


@dataclasses.dataclass
class RMATrainState(ppo.TrainState):
    """The learner's state: as learn/ppo.TrainState with an RMAPolicy."""
    policy: RMAPolicy


class RMATransition(NamedTuple):
    """One rollout step, or (stacked, leading dim T) a whole rollout."""
    obs: torch.Tensor
    privileged_obs: torch.Tensor
    obs_history: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


def init_train_state(rng, env, args: ppo.PPO_Args = ppo.PPO_Args(),
                     rma_args: RMA_Args = RMA_Args()) -> RMATrainState:
    """`rng`: a generator on the env's device, or a seed for one.  It seeds
    the initial weights and then draws the action noise and permutations."""
    if not isinstance(rng, torch.Generator):
        gen = torch.Generator(device=env.device)
        gen.manual_seed(int(rng))
        rng = gen
    policy = RMAPolicy(env.num_obs, env.num_privileged_obs,
                       env.num_obs_history, env.num_actions, rma_args,
                       generator=rng, device=env.device)
    main_opt, adapt_opt = ppo.make_optimizers(policy, args)
    return RMATrainState(policy=policy, optimizer=main_opt,
                         adapt_optimizer=adapt_opt,
                         lr=float(np.float32(args.learning_rate)), rng=rng,
                         iteration=0)


@torch.no_grad()
def collect(env, env_state, obs_dict, policy: RMAPolicy,
            gen: torch.Generator, num_steps: int, gamma: float,
            eval_expert: bool = False):
    """Roll the sampled teacher out for `num_steps` control steps over the
    first `env.num_train_envs` envs; the eval envs after them act with
    `student_mean` (the teacher's mean with `eval_expert`) and count in the
    eval episode stats only.  Returns (env_state, obs_dict, traj:
    RMATransition stacked over steps (the train envs), logs), `logs` as
    learn/ppo.collect's."""
    T = env.num_train_envs
    draw = ppo.env_rows(env).train_draw()
    steps, logs = [], []
    for _ in range(num_steps):
        obs = obs_dict["obs"]
        priv = obs_dict["privileged_obs"]
        hist = obs_dict["obs_history"]
        actions, logp, mu, sigma = policy.sample_actions(obs[:T], priv[:T],
                                                         gen, draw)
        values = policy.evaluate(obs[:T], priv[:T])
        env_actions = actions
        if env.num_eval_envs > 0:
            if eval_expert:
                actions_ev, _ = policy.teacher_mean(obs[T:], priv[T:])
            else:
                actions_ev = policy.student_mean(obs[T:], hist[T:])
            env_actions = torch.cat([actions, actions_ev], dim=0)
        env_state, obs_dict, rew, done, info = env.step(env_state,
                                                        env_actions)
        # timeout bootstrap (ppo.py:84-86)
        rew = rew[:T] + gamma * values * info.time_outs[:T].to(rew.dtype)
        steps.append(RMATransition(
            obs=obs[:T], privileged_obs=priv[:T], obs_history=hist[:T],
            actions=actions, rewards=rew, dones=done[:T], values=values,
            log_probs=logp, mu=mu, sigma=sigma.contiguous()))
        logs.append((info.ep_sums_done, info.ep_count_done, info.ep_len_done,
                     info.eval_ep_sums_done, info.eval_ep_count_done,
                     info.eval_ep_len_done, info.envelope_exits))
    traj = RMATransition(*[torch.stack(col) for col in zip(*steps)])
    logs = tuple(torch.stack(col) for col in zip(*logs))
    return env_state, obs_dict, traj, logs


def flatten_rollout(traj: RMATransition, returns, advantages):
    """(T, N, ...) -> (T*N, ...): the ten columns `update` consumes."""
    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return tuple(flat(x) for x in (
        traj.obs, traj.privileged_obs, traj.obs_history, traj.actions,
        traj.log_probs, traj.mu, traj.sigma, traj.values, returns,
        advantages))


def update(policy: RMAPolicy, optimizers, lr: float, data, perm,
           args: ppo.PPO_Args = ppo.PPO_Args(), rows=None):
    """The PPO + distillation update on one flattened rollout: `data` the
    ten (batch, ...) columns of `flatten_rollout`, `perm` one (batch,)
    permutation, shuffled ONCE; minibatches are contiguous slices of it, in
    the same order in every epoch.  `optimizers` = (main Adam over every
    parameter, Adam over the adaptation module).  Updates `policy` and the
    optimizers in place.  `rows` as in learn/ppo.update.  Returns (lr after
    the last minibatch, learn/ppo.UpdateMetrics; its adaptation_test_loss
    is the adaptation_loss)."""
    main_opt, adapt_opt = optimizers
    adapt_params = [p for g in adapt_opt.param_groups for p in g["params"]]
    if rows is None:
        rows = mesh_mod.env_rows(None, perm.shape[0])
    batches, mb = ppo.minibatches(data, perm, args.num_mini_batches, rows)
    lr = np.float32(lr)
    per_mb = []
    lrs = []
    for _ in range(args.num_learning_epochs):
        for cols, _ in batches:
            (obs_mb, priv_mb, hist_mb, act_mb, old_logp_mb, old_mu_mb,
             old_sigma_mb, tv_mb, ret_mb, adv_mb) = cols

            mean, _ = policy.teacher_mean(obs_mb, priv_mb)
            std = policy.std.expand_as(mean)
            loss, s_loss, v_loss = ppo.ppo_loss(
                mean, std, policy.evaluate(obs_mb, priv_mb), act_mb,
                old_logp_mb, adv_mb, tv_mb, ret_mb, args, mb)
            lr, kl_mean = ppo.main_step(main_opt, lr, loss, mean, std,
                                        old_mu_mb, old_sigma_mb, args,
                                        rows, mb)
            lrs.append(float(lr))

            # distillation: adaptation(hist) -> encoder(priv), the encoder
            # as the main step left it (ppo.py:157-163)
            with torch.no_grad():
                target = policy.encoder(priv_mb)
            pred = policy.adaptation(hist_mb)
            a_loss = torch.sum(torch.square(pred - target)) / (
                mb * pred.shape[1])
            ppo.adapt_step(adapt_opt, adapt_params, a_loss, rows)
            a_loss = a_loss.detach()
            per_mb.append(torch.stack([v_loss.detach(), s_loss.detach(),
                                       a_loss, a_loss, kl_mean]))
    main_opt.zero_grad(set_to_none=True)
    return float(lr), ppo.update_metrics(per_mb, lrs, rows)


def make_train_iteration(env, args: ppo.PPO_Args = ppo.PPO_Args(),
                         num_steps: int = 24, eval_expert: bool = False):
    """Teacher PPO + adaptation distillation, one iteration.

    Returns fn: (env_state, obs_dict, train_state) ->
                (env_state, obs_dict, train_state, learn/ppo.IterMetrics)

    The same contract as learn/ppo.make_train_iteration, so the Runner
    drives either variant."""
    T = env.num_train_envs
    rows = ppo.env_rows(env)

    def train_iteration(env_state, obs_dict, ts: RMATrainState):
        policy = ts.policy
        env_state, obs_dict, traj, logs = collect(
            env, env_state, obs_dict, policy, ts.rng, num_steps, args.gamma,
            eval_expert)
        with torch.no_grad():
            last_values = policy.evaluate(obs_dict["obs"][:T],
                                          obs_dict["privileged_obs"][:T])
            returns, advantages = ppo.compute_gae(traj, last_values,
                                                  args.gamma, args.lam, rows)
        data = flatten_rollout(traj, returns, advantages)
        perm = torch.randperm(num_steps * rows.num_train, generator=ts.rng,
                              device=data[0].device)
        lr, ms = update(policy, (ts.optimizer, ts.adapt_optimizer), ts.lr,
                        data, perm, args, rows)
        metrics = ppo.iter_metrics(ms, lr, traj, logs, env_state, rows)
        ts = dataclasses.replace(ts, lr=lr, iteration=ts.iteration + 1)
        return env_state, obs_dict, ts, metrics

    return train_iteration
