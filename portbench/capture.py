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
        self.seeds = job.seeds
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
        self.replicas = []     # the other ranks' {first_grad, params_after,
        #                        losses}, where the capture is gathered
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
        self.job = None        # the program's state is not the capture's


# -- a capture over several ranks ------------------------------------------------

# the env-state leaves that are one value for the whole batch, which every
# rank holds whole, and the leaf whose env axis is its last (padded to the
# control-step kernel's block): the rule of the program's parallel/mesh.py,
# copied
WHOLE_BATCH = frozenset(("rng", "common_step", "gravity_offset",
                         "curriculum", "curriculum_eval"))
ENV_MINOR = "contact_lam_t"


def _join_tree(x, name, n, join, pad):
    """A host state tree (`to_host`) of this rank's `n` rows joined over
    the ranks: the leaves with `n` rows along their first axis, the
    env-minor leaf along its last (cut to its rows, the joined one padded
    by `pad`); whole-batch leaves and the rest are this rank's."""
    if name in WHOLE_BATCH:
        return x
    if isinstance(x, torch.Tensor):
        if name == ENV_MINOR:
            g = join(x[..., :n].contiguous(), -1)
            return None if g is None else pad(g)
        return join(x, 0) if x.ndim and x.shape[0] == n else x
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
        if x[0] == "torch.Generator":
            return x
        return (x[0], {f: _join_tree(v, f, n, join, pad)
                       for f, v in x[1].items()})
    if isinstance(x, dict):
        return {k: _join_tree(v, k, n, join, pad) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_join_tree(v, name, n, join, pad) for v in x)
    return x


def join_ranks(cap, rank: int, world: int, join, pad):
    """The capture of the whole batch from each rank's capture of its rows
    (`cap`, removed): every rank calls this, and `join(x, axis)` returns the
    ranks' `x` joined along `axis` in rank order on rank 0 (None on the
    others), called on every rank in the same order.  The env rows (each
    step's reward, done and time-out, the sampled steps' states, actions
    and outputs, the rollouts, the returns and advantages) are joined in
    the global batch's order; the learner state, replicated over the
    ranks, is rank 0's, and the other ranks' first gradients, parameters
    after the iterations and losses go into `replicas`.  Rank 0 gets the
    joined capture, the others None."""
    import types
    n = cap.traj[0]["actions"].shape[1]
    steps = cap.traj[0]["actions"].shape[0]

    def tree(x):
        return _join_tree(x, "", n, join, pad)

    out = types.SimpleNamespace(seeds=cap.seeds, sample=cap.sample,
                                losses=cap.losses,
                                first_grad=cap.first_grad,
                                params_after=cap.params_after)
    out.raw = [{f: join(v, 1) for f, v in r.items()} for r in cap.raw]
    out.traj = [{f: join(v, 1) for f, v in t.items()} for t in cap.traj]
    out.last_obs = [{f: join(v, 0) for f, v in o.items()}
                    for o in cap.last_obs]
    out.gae = []
    for ret, adv in cap.gae:
        g = [join(x.view(steps, n), 1) for x in (ret, adv)]
        out.gae.append(None if rank else tuple(x.reshape(-1) for x in g))
    out.env_checks = [dict(key=c["key"], actions=join(c["actions"], 0),
                           pre=tree(c["pre"]), post=tree(c["post"]))
                      for c in cap.env_checks]
    def every(leaves):
        """Each leaf of every rank, stacked (rank 0)."""
        return {n: join(leaves[n].unsqueeze(0), 0) for n in sorted(leaves)}
    grads, params = every(cap.first_grad), every(cap.params_after)
    losses = join(torch.tensor(cap.losses, dtype=torch.float64)[None], 0)
    if rank:
        return None
    out.replicas = [dict(first_grad={n: g[r] for n, g in grads.items()},
                         params_after={n: p[r] for n, p in params.items()},
                         losses=losses[r].tolist())
                    for r in range(1, world)]
    return out
