"""Frozen copy of walk_these_ways_tpu_torch/learn/ppo.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

PPO with concurrent state estimation (ppo_cse) on PyTorch.

Counterpart of the JAX package's learn/ppo.py (reference:
go1_gym_learn/ppo_cse/ppo.py + rollout_storage.py + the rollout loop in
ppo_cse/__init__.py:138-206).  One training iteration is a 24-step rollout
through the env, GAE, 5 epochs x 4 minibatches of clipped-surrogate PPO with
KL-adaptive LR, plus the supervised adaptation-module regression.  It is
three plain functions that `make_train_iteration` composes: `collect`,
`compute_gae` and `update`.  The stacked rollout IS the storage.

The simulator is never differentiated: gradients flow through the three
MLPs of the ActorCritic only (plain `torch.matmul` products), so no kernel
needs a backward.

Parity notes (semantics matched to the reference, file:line):
- timeout bootstrap: rewards += gamma * value * time_out (ppo.py:84-86);
  the values are those taken BEFORE env.step
- GAE reverse scan (rollout_storage.py:76-90), advantages normalized over
  the whole batch with the population deviation
- one permutation per update reused across epochs (rollout_storage.py:100-124);
  minibatches are contiguous slices of the permuted data
- KL-adaptive LR: x/ 1.5 outside [desired/2, 2*desired], clamped to
  [1e-5, 1e-2], adjusted per minibatch BEFORE the gradient step
  (ppo.py:118-132); kept in float32 like the JAX package's
- the main Adam updates ALL params (incl. the adaptation module, which
  receives policy gradients through the actor's latent) with grad-norm clip
  1.0 (ppo.py:44,152-158): gradients are scaled by max_norm / norm when
  norm > max_norm, with no epsilon in the divisor
- a second Adam(1e-3) trains only the adaptation module on MSE(pred, priv)
  over the first 80% of each minibatch, with the remaining 20% as test loss
  (ppo.py:163-192); it runs after the main step on the updated params.

Data parallel over an env mesh (parallel/mesh.py; the env's `rows` split
over several ranks): each rank rolls out its rows, and the iteration keeps
the one-rank meaning.  The action noise is drawn for the whole batch and
the rank keeps its rows; the advantages are normalised with the batch's
mean and population deviation; the one permutation is of the global
(steps x train envs) batch, drawn from the replicated generator, and
minibatch i is its positions [i mb, (i + 1) mb): each rank sums its losses
over its own samples there and divides by the global mb, and the
80 / 20 adaptation split is by position in the minibatch.  The gradients
and the mean KL are summed over the ranks before the clip, the learning
rate and the Adam step, so every rank takes the same step; the logged
metrics are global.  Nothing of the rollout leaves its rank.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models import actor_critic as ac
from ..parallel import mesh as mesh_mod


@dataclasses.dataclass(frozen=True)
class PPO_Args:
    """reference ppo_cse/ppo.py:13-30"""
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    entropy_coef: float = 0.01
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    adaptation_module_learning_rate: float = 1e-3
    num_adaptation_module_substeps: int = 1
    schedule: str = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0


@dataclasses.dataclass
class TrainState:
    """The learner's state.  The policy and the optimizers are updated in
    place by `update`; `lr`, `iteration` are replaced."""
    policy: ac.ActorCritic
    optimizer: torch.optim.Adam          # all parameters, lr set per minibatch
    adapt_optimizer: torch.optim.Adam    # the adaptation module only
    lr: float                            # adaptive learning rate (a float32)
    rng: torch.Generator                 # action noise and the permutation
    iteration: int = 0


class IterMetrics(NamedTuple):
    value_loss: torch.Tensor
    surrogate_loss: torch.Tensor
    adaptation_loss: torch.Tensor
    adaptation_test_loss: torch.Tensor
    mean_kl: torch.Tensor
    lr: float
    mean_reward: torch.Tensor          # mean per-step reward this iter
    ep_sums_done: torch.Tensor         # (n_terms+1,) summed over finished eps
    ep_count_done: torch.Tensor
    ep_len_done: torch.Tensor
    # eval-slice episode stats (zero without eval envs)
    eval_ep_sums_done: torch.Tensor
    eval_ep_count_done: torch.Tensor
    eval_ep_len_done: torch.Tensor
    curriculum_area: torch.Tensor      # (C,) mean weight per gait category
    # crash-guard terminations this iteration; a healthy run logs 0
    envelope_exits: torch.Tensor


class Transition(NamedTuple):
    """One rollout step, or (stacked, leading dim T) a whole rollout."""
    obs_history: torch.Tensor
    privileged_obs: torch.Tensor
    actions: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    values: torch.Tensor
    log_probs: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor


class UpdateMetrics(NamedTuple):
    """Per minibatch update, in order (epochs x minibatches,)."""
    value_loss: torch.Tensor
    surrogate_loss: torch.Tensor
    adaptation_loss: torch.Tensor
    adaptation_test_loss: torch.Tensor
    kl: torch.Tensor
    lr: tuple                          # the lr each update's step used


def make_optimizers(policy: ac.ActorCritic, args: PPO_Args):
    main = torch.optim.Adam(policy.parameters(), lr=args.learning_rate,
                            eps=1e-8)
    adapt = torch.optim.Adam(policy.adaptation.parameters(),
                             lr=args.adaptation_module_learning_rate,
                             eps=1e-8)
    return main, adapt


def init_train_state(rng, env, args: PPO_Args = PPO_Args()) -> TrainState:
    """`rng`: a generator on the env's device, or a seed for one.  It seeds
    the initial weights and then draws the action noise and permutations."""
    if not isinstance(rng, torch.Generator):
        gen = torch.Generator(device=env.device)
        gen.manual_seed(int(rng))
        rng = gen
    policy = ac.ActorCritic(env.num_obs, env.num_privileged_obs,
                            env.num_obs_history, env.num_actions,
                            generator=rng, device=env.device)
    main_opt, adapt_opt = make_optimizers(policy, args)
    return TrainState(policy=policy, optimizer=main_opt,
                      adapt_optimizer=adapt_opt,
                      lr=float(np.float32(args.learning_rate)), rng=rng,
                      iteration=0)


# -- the three parts of an iteration ------------------------------------------


@torch.no_grad()
def collect(env, env_state, obs_dict, policy: ac.ActorCritic,
            gen: torch.Generator, num_steps: int, gamma: float,
            eval_expert: bool = False):
    """Roll the sampled policy out for `num_steps` control steps.

    Train/eval env split (reference ppo_cse/__init__.py:140-147): only the
    first `env.num_train_envs` envs draw action noise and give values,
    rewards, dones and the trajectory; the eval envs after them act with
    the student's mean (`actor_mean`), or with the teacher
    (`act_teacher`) when `eval_expert`, and count in the eval episode
    stats only.

    Returns (env_state, obs_dict, traj: Transition stacked over steps (the
    train envs), logs: tuple of per-step stacked (ep_sums_done,
    ep_count_done, ep_len_done, eval_ep_sums_done, eval_ep_count_done,
    eval_ep_len_done, envelope_exits))."""
    T = env.num_train_envs
    draw = env_rows(env).train_draw()
    steps, logs = [], []
    for _ in range(num_steps):
        hist = obs_dict["obs_history"][:T]
        priv = obs_dict["privileged_obs"][:T]
        actions, logp, mu, sigma = policy.sample_actions(hist, gen, draw)
        env_actions = actions
        if env.num_eval_envs > 0:
            hist_ev = obs_dict["obs_history"][T:]
            if eval_expert:
                actions_ev = policy.act_teacher(
                    hist_ev, obs_dict["privileged_obs"][T:])
            else:
                actions_ev = policy.actor_mean(hist_ev)
            env_actions = torch.cat([actions, actions_ev], dim=0)
        values = policy.evaluate(hist, priv)
        env_state, obs_dict, rew, done, info = env.step(env_state,
                                                        env_actions)
        # timeout bootstrap (ppo.py:84-86)
        rew = rew[:T] + gamma * values * info.time_outs[:T].to(rew.dtype)
        steps.append(Transition(
            obs_history=hist, privileged_obs=priv, actions=actions,
            rewards=rew, dones=done[:T], values=values, log_probs=logp,
            mu=mu, sigma=sigma.contiguous()))
        logs.append((info.ep_sums_done, info.ep_count_done, info.ep_len_done,
                     info.eval_ep_sums_done, info.eval_ep_count_done,
                     info.eval_ep_len_done, info.envelope_exits))
    traj = Transition(*[torch.stack(col) for col in zip(*steps)])
    logs = tuple(torch.stack(col) for col in zip(*logs))
    return env_state, obs_dict, traj, logs


def env_rows(env) -> mesh_mod.EnvRows:
    """The env's rows (parallel/mesh.EnvRows); one rank's rows of its train
    envs for an env that has none."""
    rows = getattr(env, "rows", None)
    return rows if rows is not None else mesh_mod.env_rows(
        None, env.num_train_envs)


def compute_gae(traj: Transition, last_values: torch.Tensor,
                gamma: float, lam: float, rows=None):
    """Reverse scan over the (T, N) rollout.  Returns (returns (T, N),
    advantages normalized over the whole batch (T, N)): with `rows` (a
    split env's) over every rank's envs, the mean and the population
    deviation summed over the ranks."""
    T = traj.rewards.shape[0]
    adv = torch.zeros_like(last_values)
    advs = [None] * T
    next_values = last_values
    for k in range(T - 1, -1, -1):
        not_terminal = 1.0 - traj.dones[k].to(torch.float32)
        delta = traj.rewards[k] + not_terminal * gamma * next_values \
            - traj.values[k]
        adv = delta + not_terminal * gamma * lam * adv
        advs[k] = adv
        next_values = traj.values[k]
    advs = torch.stack(advs)
    returns = advs + traj.values
    if rows is None:
        rows = mesh_mod.env_rows(None, advs.shape[1])
    n = advs.shape[0] * rows.num_train
    mean = rows.all_reduce_sum([advs.sum()])[0] / n
    var = rows.all_reduce_sum([torch.sum(torch.square(advs - mean))])[0] / n
    return returns, (advs - mean) / (torch.sqrt(var) + 1e-8)


def _clip_by_global_norm(params, max_norm: float):
    """Scale the gradients by max_norm / norm when norm > max_norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)


@torch.no_grad()
def mean_kl(mean, std, old_mu, old_sigma, n: int):
    """This rank's part of the mean over a minibatch of `n` samples (spread
    over the ranks) of KL(old || new) of the diagonal Gaussians."""
    kl = torch.sum(
        torch.log(std / old_sigma + 1e-5)
        + (torch.square(old_sigma) + torch.square(old_mu - mean))
        / (2.0 * torch.square(std)) - 0.5, dim=-1)
    return torch.sum(kl) / n


def adaptive_lr(lr, kl_mean, args: PPO_Args):
    """The KL-adaptive learning rate in float32 (ppo.py:118-132): / 1.5 when
    the KL exceeds twice the desired one, x 1.5 when it is below half of it,
    clamped to [1e-5, 1e-2]."""
    f32 = np.float32
    lr = f32(lr)
    kl_f = f32(kl_mean.item())
    if kl_f > f32(args.desired_kl * 2.0):
        lr = max(f32(1e-5), lr / f32(1.5))
    if kl_f < f32(args.desired_kl / 2.0) and kl_f > f32(0.0):
        lr = min(f32(1e-2), lr * f32(1.5))
    return lr


def ppo_loss(mean, std, value, actions, old_log_probs, advantages,
             target_values, returns, args: PPO_Args, n: int):
    """(loss, surrogate loss, value loss) of one minibatch: the clipped
    surrogate, the clipped value loss (ppo.py:100-116) and the entropy
    bonus, each this rank's part of the mean over the minibatch's `n`
    samples (spread over the ranks)."""
    ratio = torch.exp(ac.gaussian_log_prob(actions, mean, std)
                      - old_log_probs)
    surr = -advantages * ratio
    surr_clipped = -advantages * torch.clamp(
        ratio, 1.0 - args.clip_param, 1.0 + args.clip_param)
    s_loss = torch.sum(torch.maximum(surr, surr_clipped)) / n
    if args.use_clipped_value_loss:
        v_clipped = target_values + torch.clamp(
            value - target_values, -args.clip_param, args.clip_param)
        v_loss = torch.sum(torch.maximum(
            torch.square(value - returns),
            torch.square(v_clipped - returns))) / n
    else:
        v_loss = torch.sum(torch.square(returns - value)) / n
    entropy = ac.gaussian_entropy(std)
    loss = s_loss + args.value_loss_coef * v_loss \
        - args.entropy_coef * torch.sum(entropy) / n
    return loss, s_loss, v_loss


def main_step(main_opt, lr, loss, mean, std, old_mu, old_sigma,
              args: PPO_Args, rows, n: int):
    """The main Adam step of one minibatch: backward, the KL-adaptive
    learning rate set BEFORE the step (ppo.py:118-132), the global-norm
    clip over every parameter, the step.  A parameter the loss does not
    reach steps on a zero gradient, as in the JAX package's optax Adam,
    which spans every parameter (torch's Adam would skip one whose grad is
    None, and its moments and step count would fall behind).  The loss is
    the rank's part of `rows` (a split env's; `n` the minibatch's global
    size), and the gradients and the KL are summed over the ranks first, in
    one collective (none on one rank).  Returns (lr, mean KL)."""
    params = [p for g in main_opt.param_groups for p in g["params"]]
    main_opt.zero_grad(set_to_none=True)
    loss.backward()
    kl_mean = mean_kl(mean, std, old_mu, old_sigma, n)
    with torch.no_grad():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        *grads, kl_mean = rows.all_reduce_sum(
            [p.grad for p in params] + [kl_mean])
        for p, g in zip(params, grads):
            p.grad = g
    lr = adaptive_lr(lr, kl_mean, args)
    for group in main_opt.param_groups:
        group["lr"] = float(lr)
    with torch.no_grad():
        _clip_by_global_norm(params, args.max_grad_norm)
    main_opt.step()
    return lr, kl_mean


def flatten_rollout(traj: Transition, returns, advantages):
    """(T, N, ...) -> (T*N, ...): the nine columns `update` consumes."""
    def flat(x):
        return x.reshape((-1,) + tuple(x.shape[2:]))
    return tuple(flat(x) for x in (
        traj.obs_history, traj.privileged_obs, traj.actions, traj.log_probs,
        traj.mu, traj.sigma, traj.values, returns, advantages))


def minibatches(data, perm, num_mini_batches: int, rows):
    """([(minibatch columns, positions in the minibatch)], mb): minibatch
    i is the global positions [i mb, (i + 1) mb) of `perm`, a permutation
    of the global (steps x train envs) batch of `rows` (the env's), with
    mb = batch // num_mini_batches; of it, this rank's samples in `data`,
    its flattened rollout, and their positions there.  On one rank these
    are the contiguous slices of the data shuffled by `perm`."""
    T, t, r0 = rows.num_train, rows.t, rows.train.start
    env = perm % T
    mine = (env >= r0) & (env < r0 + t)
    local = (perm // T) * t + (env - r0)
    mb = perm.shape[0] // num_mini_batches
    out = []
    for i in range(num_mini_batches):
        seg = slice(i * mb, (i + 1) * mb)
        pos = torch.nonzero(mine[seg]).squeeze(1)
        out.append((tuple(x[local[seg][pos]] for x in data), pos))
    return out, mb


def split_mse(pred, target, pos, num_train: int, mb: int):
    """(MSE over the minibatch's first `num_train` positions, MSE over the
    rest, without gradient): the adaptation module's train and test losses
    (ppo.py:163-192): the rank's parts of them, `pos` its samples'
    positions in the minibatch of `mb`."""
    sq = torch.square(pred - target)
    first = (pos < num_train)[:, None]
    zero = torch.zeros((), device=sq.device)
    width = sq.shape[1]
    return (torch.sum(torch.where(first, sq, zero)) / (num_train * width),
            torch.sum(torch.where(first, zero, sq)).detach()
            / ((mb - num_train) * width))


def adapt_step(adapt_opt, adapt_params, loss, rows):
    """The adaptation module's Adam step on `loss`, its gradients summed
    over the ranks of `rows`."""
    grads = rows.all_reduce_sum(torch.autograd.grad(loss, adapt_params))
    for p, g in zip(adapt_params, grads):
        p.grad = g
    adapt_opt.step()


def update_metrics(per_mb, lrs, rows):
    """UpdateMetrics of the (minibatches, 5) rows [value, surrogate,
    adaptation, adaptation test loss, KL]: the four losses are the ranks'
    parts, summed here in one collective (the KL is global already)."""
    m = torch.stack(per_mb)
    m = torch.cat([rows.all_reduce_sum([m[:, :4]])[0], m[:, 4:]], dim=1)
    return UpdateMetrics(
        value_loss=m[:, 0], surrogate_loss=m[:, 1], adaptation_loss=m[:, 2],
        adaptation_test_loss=m[:, 3], kl=m[:, 4], lr=tuple(lrs))


def update(policy: ac.ActorCritic, optimizers, lr: float, data, perm,
           args: PPO_Args = PPO_Args(), rows=None):
    """The PPO update on one flattened rollout: `data` the nine
    (batch, ...) columns of `flatten_rollout`, `perm` one (batch,)
    permutation.  The data is shuffled ONCE; minibatches are contiguous
    slices of it, in the same order in every epoch.  `optimizers` =
    (main Adam over all parameters, Adam over the adaptation module).
    Updates `policy` and the optimizers in place.  `rows` are the env's
    (one rank's of `perm`'s batch by default): `data` is the rank's
    rollout and `perm` the global batch's (see `minibatches`).  Returns (lr
    after the last minibatch, UpdateMetrics)."""
    main_opt, adapt_opt = optimizers
    adapt_params = [p for g in adapt_opt.param_groups for p in g["params"]]
    if rows is None:
        rows = mesh_mod.env_rows(None, perm.shape[0])
    batches, mb = minibatches(data, perm, args.num_mini_batches, rows)
    lr = np.float32(lr)
    per_mb = []
    lrs = []
    for _ in range(args.num_learning_epochs):
        for cols, pos in batches:
            (hist_mb, priv_mb, act_mb, old_logp_mb, old_mu_mb, old_sigma_mb,
             tv_mb, ret_mb, adv_mb) = cols

            mean = policy.actor_mean(hist_mb)
            std = policy.std.expand_as(mean)
            loss, s_loss, v_loss = ppo_loss(
                mean, std, policy.evaluate(hist_mb, priv_mb), act_mb,
                old_logp_mb, adv_mb, tv_mb, ret_mb, args, mb)
            lr, kl_mean = main_step(main_opt, lr, loss, mean, std, old_mu_mb,
                                    old_sigma_mb, args, rows, mb)
            lrs.append(float(lr))

            # adaptation substep on the updated params (ppo.py:163-192)
            num_train = mb // 5 * 4
            a_loss = torch.zeros((), device=hist_mb.device)
            a_test = torch.zeros((), device=hist_mb.device)
            for _ in range(args.num_adaptation_module_substeps):
                pred = policy.adaptation_forward(hist_mb)
                a_loss, a_test = split_mse(pred, priv_mb, pos, num_train, mb)
                adapt_step(adapt_opt, adapt_params, a_loss, rows)
            per_mb.append(torch.stack([v_loss.detach(), s_loss.detach(),
                                       a_loss.detach(), a_test, kl_mean]))
    main_opt.zero_grad(set_to_none=True)
    return float(lr), update_metrics(per_mb, lrs, rows)


def iter_metrics(ms: UpdateMetrics, lr, traj, logs, env_state, rows):
    """The iteration's IterMetrics from the update's metrics, the rollout
    and its per-step logs: the reward mean and the episode statistics
    summed over the ranks of `rows` (the env's) in one collective."""
    total, *ep = rows.all_reduce_sum([
        traj.rewards.sum(), logs[0].sum(dim=0), logs[1].sum(), logs[2].sum(),
        logs[3].sum(dim=0), logs[4].sum(), logs[5].sum(), logs[6].sum()])
    mean_reward = total / (traj.rewards.shape[0] * rows.num_train)
    return IterMetrics(
        value_loss=ms.value_loss.mean(),
        surrogate_loss=ms.surrogate_loss.mean(),
        adaptation_loss=ms.adaptation_loss.mean(),
        adaptation_test_loss=ms.adaptation_test_loss.mean(),
        mean_kl=ms.kl.mean(),
        lr=lr,
        mean_reward=mean_reward,
        ep_sums_done=ep[0], ep_count_done=ep[1], ep_len_done=ep[2],
        eval_ep_sums_done=ep[3], eval_ep_count_done=ep[4],
        eval_ep_len_done=ep[5],
        curriculum_area=torch.mean(env_state.curriculum.weights, dim=-1),
        envelope_exits=ep[6],
    )


# -- the iteration -------------------------------------------------------------


def make_train_iteration(env, args: PPO_Args = PPO_Args(),
                         num_steps: int = 24, eval_expert: bool = False):
    """Build the one-iteration training function.

    Returns fn: (env_state, obs_dict, train_state) ->
                (env_state, obs_dict, train_state, IterMetrics)

    The first `env.num_train_envs` envs act with the sampled student and
    feed PPO; eval envs after them act deterministically (see `collect`,
    `eval_expert`) and give only the eval episode metrics."""
    T = env.num_train_envs
    rows = env_rows(env)

    def train_iteration(env_state, obs_dict, ts: TrainState):
        policy = ts.policy
        # -- rollout (ppo_cse/__init__.py:138-186) ------------------------
        env_state, obs_dict, traj, logs = collect(
            env, env_state, obs_dict, policy, ts.rng, num_steps, args.gamma,
            eval_expert)

        # -- GAE (ppo.py:93-95) over the train envs -----------------------
        with torch.no_grad():
            last_values = policy.evaluate(obs_dict["obs_history"][:T],
                                          obs_dict["privileged_obs"][:T])
            returns, advantages = compute_gae(traj, last_values, args.gamma,
                                              args.lam, rows)

        # -- update: one permutation, reused across epochs ----------------
        data = flatten_rollout(traj, returns, advantages)
        perm = torch.randperm(num_steps * rows.num_train, generator=ts.rng,
                              device=data[0].device)
        lr, ms = update(policy, (ts.optimizer, ts.adapt_optimizer), ts.lr,
                        data, perm, args, rows)

        metrics = iter_metrics(ms, lr, traj, logs, env_state, rows)
        ts = dataclasses.replace(ts, lr=lr, iteration=ts.iteration + 1)
        return env_state, obs_dict, ts, metrics

    return train_iteration
