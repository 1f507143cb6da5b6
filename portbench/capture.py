"""What the reference needs from the program's first iterations, read from
the objects the timed path uses while those iterations run through the
window's own call: each env step's reward, done and time-out; the whole
state before and the outputs after the sampled env steps; each rollout
(observations, actions, the policy's means, log-probs and values); the
returns and advantages the update is given; each optimiser's state after
its first step; each iteration's losses; and the parameters after the
last.  Everything is copied to the host as it comes, so that the device
holds none of it during the window."""
from __future__ import annotations

import numpy as np
import torch


def to_host(x):
    """A copy of a state tree on the host: named tuples as (type name,
    {field: copy}), generators as their state."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, torch.Generator):
        return ("torch.Generator", x.get_state())
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, {f: to_host(getattr(x, f))
                                   for f in x._fields})
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_host(v) for v in x)
    return x


def sample_steps(seed: int, iterations: int, steps: int, n: int):
    """`n` distinct (iteration, step) pairs drawn from `seed`, one in each
    of the first `n` iterations where there are as many."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        out.append((k % iterations, int(rng.integers(steps))))
    return sorted(set(out))


def record_first_steps(policy, main_opt, adapt_opt, into: dict):
    """Hooks that put into `into` each optimiser's gradient as it got it
    at its first step, worked out from its state after that step
    (exp_avg / (1 - beta1)), under "main:<leaf>" and "adapt:<leaf>"."""
    names = {id(p): n for n, p in policy.named_parameters()}
    handles = []
    for tag, opt in (("main", main_opt), ("adapt", adapt_opt)):
        def hook(o, _a, _kw, tag=tag):
            if any(k.startswith(tag + ":") for k in into):
                return
            for g in o.param_groups:
                for p in g["params"]:
                    into[f"{tag}:{names[id(p)]}"] = (
                        o.state[p]["exp_avg"] / (1.0 - g["betas"][0])
                    ).to("cpu", copy=True)
        handles.append(opt.register_step_post_hook(hook))
    return handles


class Capture:
    """Install on a job before its first iteration; call `begin(k)` before
    iteration k, `end(metrics)` after it and `remove()` after the last."""

    def __init__(self, job, sample):
        self.job = job
        self.sample = set(sample)
        self.k = -1
        self.t = 0
        self.raw = []          # per iteration: {rew, done, time_outs} (T, N)
        self.env_checks = []   # {key, pre, actions, post}
        self.traj = []         # per iteration: {field: (T, N, ...)}
        self.last_obs = []     # per iteration: the obs dict after the rollout
        self.gae = []          # per iteration: (returns, advantages) flat
        self.losses = []       # per iteration: value + surrogate loss
        self.first_grad = {}   # "main:<leaf>" / "adapt:<leaf>" -> gradient
        self.params_after = None
        self._undo = []
        self._step_buf = None

    # -- wrappers ------------------------------------------------------------
    def install(self):
        job = self.job
        env, learner = job.env, job.side.learner
        T = env.num_train_envs
        orig_step, orig_collect, orig_update = (
            env.step, learner.collect, learner.update)

        def step(state, actions):
            key = (self.k, self.t)
            pre = act = None
            if key in self.sample:
                pre, act = to_host(state), to_host(actions)
            out = orig_step(state, actions)
            state2, obs_dict, rew, done, info = out
            self._step_buf.append((rew[:T].detach().clone(),
                                   done[:T].detach().clone(),
                                   info.time_outs[:T].detach().clone()))
            if pre is not None:
                self.env_checks.append(dict(
                    key=key, pre=pre, actions=act,
                    post=to_host((state2, obs_dict, rew, done))))
            self.t += 1
            return out

        def collect(*a, **kw):
            self.t = 0
            self._step_buf = []
            out = orig_collect(*a, **kw)
            _, obs_dict, traj, _ = out
            self.traj.append({f: getattr(traj, f).to("cpu", copy=True)
                              for f in traj._fields
                              if f not in ("rewards", "dones", "sigma")})
            self.last_obs.append({k: v[:T].to("cpu", copy=True)
                                  for k, v in obs_dict.items()})
            rew, done, tout = (torch.stack(c).cpu()
                               for c in zip(*self._step_buf))
            self.raw.append(dict(rew=rew, done=done, time_outs=tout))
            return out

        def update(*a, **kw):
            data = a[3] if len(a) > 3 else kw["data"]
            self.gae.append((data[-2].to("cpu", copy=True),
                             data[-1].to("cpu", copy=True)))
            return orig_update(*a, **kw)

        env.step = step
        learner.collect = collect
        learner.update = update
        self._undo += [lambda: delattr(env, "step"),
                       lambda: setattr(learner, "collect", orig_collect),
                       lambda: setattr(learner, "update", orig_update)]

        self._undo += [h.remove for h in record_first_steps(
            job.ts.policy, job.ts.optimizer, job.ts.adapt_optimizer,
            self.first_grad)]

    def begin(self, k: int):
        self.k = k

    def end(self, metrics):
        self.losses.append(float(metrics.value_loss + metrics.surrogate_loss))

    def remove(self):
        for undo in reversed(self._undo):
            undo()
        self._undo = []
        self.params_after = {n: p.detach().to("cpu", copy=True)
                             for n, p in self.job.ts.policy.named_parameters()}
