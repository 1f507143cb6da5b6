"""The comparison that decides `correct`: the plain reference the cell's
configuration names (portbench.reference.wtw by default, a frozen copy of
the program's plain code that imports nothing of the program) follows what
the timed path produced in the job's first iterations (portbench.capture);
on a cell over several ranks, the capture joined over the ranks, which the
one-rank reference follows as the whole batch.

- The env steps: at each sampled step the reference env steps from the
  program's own state before it (the generator's state included) with the
  program's actions, and the kernel's physics state, the observations, the
  rewards and the dones after it are compared with the program's.
- The learner: the reference makes its own weights from the seed, its own
  action noise and permutations from the learner's seed, and follows the
  program's rollouts (their observations and actions, the env's rewards,
  dones and time-outs) through the iterations: its policy's means,
  log-probs, values and sampled actions and its GAE against the program's
  (first iteration, where both start from the same weights), each
  iteration's loss, the first gradient of each optimiser (from its state
  after one step), and each leaf's change of the parameters over the
  iterations; over several ranks the loss, the gradients and the change
  are each rank's (the learner state is replicated), the worst rank
  counting.

Every number is a gap read against a scale of the reference's own, so
that 0 is agreement; `verdict` holds each against its limit."""
from __future__ import annotations

import math

import numpy as np
import torch

from . import capture
from . import job as job_mod

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone, and is left out of `change`
ROUNDOFF_GRAD_SHARE = 1e-3


def rms(x: torch.Tensor) -> float:
    x = x.double()
    return float(torch.sqrt(torch.mean(x * x))) if x.numel() else 0.0


def gap(prog: torch.Tensor, ref: torch.Tensor, scale: float) -> float:
    """Largest |prog - ref| over `scale`; inf where the program's value is
    not finite or the shapes differ."""
    if tuple(prog.shape) != tuple(ref.shape):
        return math.inf
    prog, ref = prog.double(), ref.double()
    if not bool(torch.isfinite(prog).all()):
        return math.inf
    d = float(torch.max(torch.abs(prog - ref))) if prog.numel() else 0.0
    return d / max(scale, 1e-30)


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of its reference norm
    and the median leaf's; inf for a leaf the program lacks, shapes
    differently or holds a value that is not finite in."""
    names = sorted(ref if keep is None else keep)
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names}
    med = float(np.median(list(rn.values())))
    out = {}
    for n in names:
        p = prog.get(n)
        if p is None or tuple(p.shape) != tuple(ref[n].shape) \
                or not bool(torch.isfinite(p).all()):
            out[n] = math.inf
            continue
        pn = float(torch.linalg.vector_norm(p.double()))
        out[n] = abs(pn - rn[n]) / max(rn[n], med, 1e-30)
    return out


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap (`leaf_gaps`)."""
    return max(leaf_gaps(prog, ref, keep).values())


# -- the env steps -------------------------------------------------------------


def from_host(x, types: dict, device):
    """A host state tree (capture.to_host) as the reference's types on
    `device`: each named tuple takes the reference type's fields from the
    program's fields of the same name."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], str):
        name, val = x
        if name == "torch.Generator":
            g = torch.Generator(device=device)
            g.set_state(val)
            return g
        if name in types:
            t = types[name]
            return t(**{f: from_host(val[f], types, device)
                        for f in t._fields if f in val})
    if isinstance(x, dict):
        return {k: from_host(v, types, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(from_host(v, types, device) for v in x)
    return x


PHYSICS_LEAVES = ("base_pos", "base_quat", "base_lin_vel", "base_ang_vel",
                  "q", "qd")

# the envs allowed to part from the reference in one env step: where
# rounding puts one env's contact on the other side of a branch (a point
# entering or leaving contact, sticking or sliding), the two sides take
# different, equally valid steps for that env, its physics gap reads as
# large as a fault's in that env, and its observations, reward and done
# follow (PERF.md).  Such an env is rare (three in some 450 sampled
# steps); two are allowed in one step, three fail.  A physics gap over
# PARTING_GAP is no rounding: sound envs read 3.2e-4 at most, parting ones
# 0.21 and more.
PARTING_ENVS = 2
PARTING_GAP = 1e-2


def per_env_gap(prog, ref, scale: float, env_axis: int):
    """|prog - ref| / scale, the largest over each env's elements: (N,);
    inf for an env whose program value is not finite, or everywhere where
    the shapes differ."""
    n = ref.shape[env_axis]
    if tuple(prog.shape) != tuple(ref.shape):
        return torch.full((n,), math.inf, dtype=torch.float64)
    d = torch.abs(prog.double() - ref.double()) / max(scale, 1e-30)
    d = torch.where(torch.isfinite(prog.double()), d,
                    torch.full_like(d, math.inf))
    d = torch.movedim(d, env_axis, 0).reshape(n, -1)
    return d.amax(dim=1) if d.shape[1] else torch.zeros(n, dtype=d.dtype)


def parting_envs(phys: torch.Tensor) -> torch.Tensor:
    """The envs of one step that part from the reference: of the
    PARTING_ENVS envs with the largest physics gap, those over
    PARTING_GAP (a value that is not finite is no parting)."""
    top = torch.argsort(phys, descending=True)[:PARTING_ENVS]
    gaps = phys[top]
    return top[(gaps > PARTING_GAP) & torch.isfinite(gaps)]


def all_but(per_env: torch.Tensor, left_out: torch.Tensor) -> float:
    """The largest gap of the envs not in `left_out` (0 where none is
    left)."""
    keep = torch.ones(per_env.shape, dtype=torch.bool)
    keep[left_out] = False
    return float(per_env[keep].max()) if bool(keep.any()) else 0.0


def env_step_numbers(ref_env, R, checks, device):
    """(numbers, readings of a step that returns its state unchanged, where
    the largest gaps lie) over the sampled env steps.  `physics` and `obs`
    are each env's largest gap over its state (its observations), scaled
    by the leaf's step change (its RMS), `reward` its reward's gap and
    `done` the share of envs whose done differs, each once the envs that
    part (`parting_envs`) are left out, so that a fault in three envs or
    more (a block or a wave edge not stepped) fails, as does one in an
    env's reward or done whose physics agrees."""
    types = {"EnvState": R.go1_env.EnvState,
             "PhysicsState": R.engine.PhysicsState,
             "CurriculumState": R.curriculum.CurriculumState}
    out = dict(physics=0.0, obs=0.0, reward=0.0, done=0.0)
    stale = dict(physics=0.0, obs=0.0)
    worst = dict(physics_any_env=0.0, obs_any_env=0.0, parting=[])
    for c in checks:
        pre = from_host(c["pre"], types, device)
        actions = c["actions"].to(device)
        st_p, obs_p, rew_p, done_p = c["post"]
        st_r, obs_r, rew_r, done_r, _ = ref_env.step(pre, actions)
        N = rew_r.shape[0]
        phys_p, phys_pre = st_p[1]["phys"][1], c["pre"][1]["phys"][1]
        leaves = [(f, phys_p[f], getattr(st_r.phys, f), phys_pre[f], 0)
                  for f in PHYSICS_LEAVES]
        leaves.append(("torques", st_p[1]["torques"], st_r.torques,
                       c["pre"][1]["torques"], 0))
        leaves.append(("contact_lam_t", st_p[1]["contact_lam_t"][..., :N],
                       st_r.contact_lam_t[..., :N],
                       c["pre"][1]["contact_lam_t"][..., :N], -1))
        phys = torch.zeros(N, dtype=torch.float64)
        phys_stale = torch.zeros(N, dtype=torch.float64)
        by_leaf = {}
        for name, p, r, before, axis in leaves:
            r = r.cpu()
            scale = max(rms(r - before), 1e-3 * rms(r), 1e-12)
            g = per_env_gap(p, r, scale, axis)
            by_leaf[name] = g
            phys = torch.maximum(phys, g)
            phys_stale = torch.maximum(
                phys_stale, per_env_gap(before, r, scale, axis))
        parting = parting_envs(phys)
        out["physics"] = max(out["physics"], all_but(phys, parting))
        stale_parting = parting_envs(phys_stale)
        stale["physics"] = max(stale["physics"],
                               all_but(phys_stale, stale_parting))
        worst["physics_any_env"] = max(worst["physics_any_env"],
                                       float(phys.max()))
        for e in torch.argsort(phys, descending=True)[:3].tolist():
            if phys[e] > PARTING_GAP:
                worst["parting"].append(dict(
                    step=c["key"], env=e, gap=float(phys[e]),
                    leaves={n: float(g[e]) for n, g in by_leaf.items()},
                    lam_prog=float(torch.linalg.vector_norm(
                        st_p[1]["contact_lam_t"][..., e])),
                    lam_ref=float(torch.linalg.vector_norm(
                        st_r.contact_lam_t[..., e].cpu()))))
        nobs = obs_r["obs"].shape[1]
        obs = torch.zeros(N, dtype=torch.float64)
        for key in ("obs", "privileged_obs"):
            r = obs_r[key].cpu()
            obs = torch.maximum(obs, per_env_gap(obs_p[key], r, rms(r), 0))
        out["obs"] = max(out["obs"], all_but(obs, parting))
        worst["obs_any_env"] = max(worst["obs_any_env"], float(obs.max()))
        r = obs_r["obs"].cpu()
        before = c["pre"][1]["obs_history"][:, -nobs:]
        stale["obs"] = max(stale["obs"], all_but(
            per_env_gap(before, r, rms(r), 0), stale_parting))
        r = rew_r.cpu()
        out["reward"] = max(out["reward"], all_but(
            per_env_gap(rew_p, r, rms(r), 0), parting))
        differ = done_p.cpu() != done_r.cpu()
        differ[parting] = False
        out["done"] = max(out["done"], float(differ.double().mean()))
    return out, stale, worst


# -- the learner ----------------------------------------------------------------


def _policy_outputs(policy, algo, cols, t):
    if algo == "cse":
        mu = policy.actor_mean(cols["obs_history"][t])
        values = policy.evaluate(cols["obs_history"][t],
                                 cols["privileged_obs"][t])
    else:
        mu, _ = policy.teacher_mean(cols["obs"][t], cols["privileged_obs"][t])
        values = policy.evaluate(cols["obs"][t], cols["privileged_obs"][t])
    return mu, values


def learner_numbers(cap, cell, R, device):
    """The learner's numbers: policy and gae (first iteration), loss
    (worst iteration), grad (first gradients) and change (the parameters'
    change over the iterations)."""
    cfg = cell.config
    algo = cfg["algo"]
    seeds = cap.seeds
    N = cap.traj[0]["actions"].shape[1]
    steps = cap.traj[0]["actions"].shape[0]
    args = R.ppo.PPO_Args(**cfg["ppo"])
    env_stub = type("EnvDims", (), dict(
        num_obs=cfg["num_obs"], num_privileged_obs=cfg["num_privileged_obs"],
        num_obs_history=cfg["num_obs_history"],
        num_actions=cfg["num_actions"], device=device))()
    ts = R.learner.init_train_state(
        job_mod.generator(seeds["learner"], device), env_stub, args)
    weights = job_mod.make_weights(cfg, seeds["weights"], device)
    job_mod.load_weights(ts.policy, weights)
    policy = ts.policy
    gen = job_mod.generator(seeds["learner"], device)
    rows = R.mesh.env_rows(None, N)
    first_grad = {}
    hooks = capture.record_first_steps(policy, ts.optimizer,
                                       ts.adapt_optimizer, first_grad)

    out = dict(policy=0.0, gae=0.0, loss=0.0)
    ref_losses = []
    lr = ts.lr
    ac = R.actor_critic
    for k in range(len(cap.traj)):
        cols = {f: v.to(device) for f, v in cap.traj[k].items()}
        raw = {f: v.to(device) for f, v in cap.raw[k].items()}
        with torch.no_grad():
            mus, vals, logps, acts = [], [], [], []
            std = policy.std
            for t in range(steps):
                mu, values = _policy_outputs(policy, algo, cols, t)
                s = std.expand_as(mu)
                eps = ac.noise_like(mu, gen, (N, slice(None)))
                acts.append(mu + s * eps)
                logps.append(ac.gaussian_log_prob(cols["actions"][t], mu, s))
                mus.append(mu)
                vals.append(values)
            mu, values, logp, actions = (torch.stack(x) for x in
                                         (mus, vals, logps, acts))
            last = {f: v.to(device) for f, v in cap.last_obs[k].items()}
            if algo == "cse":
                last_v = policy.evaluate(last["obs_history"],
                                         last["privileged_obs"])
            else:
                last_v = policy.evaluate(last["obs"], last["privileged_obs"])
            rewards = raw["rew"] + args.gamma * values * \
                raw["time_outs"].to(values.dtype)
            sigma = std.expand_as(mu).contiguous()
            common = dict(privileged_obs=cols["privileged_obs"],
                          obs_history=cols["obs_history"],
                          actions=cols["actions"], rewards=rewards,
                          dones=raw["done"], values=values, log_probs=logp,
                          mu=mu, sigma=sigma)
            if algo == "cse":
                traj = R.ppo.Transition(**common)
            else:
                traj = R.learner.RMATransition(obs=cols["obs"], **common)
            returns, adv = R.ppo.compute_gae(traj, last_v, args.gamma,
                                             args.lam, rows)
        if k == 0:
            for p, r in ((cols["mu"], mu), (cols["values"], values),
                         (cols["log_probs"], logp),
                         (cols["actions"], actions)):
                out["policy"] = max(out["policy"],
                                    gap(p.cpu(), r.cpu(), rms(r.cpu())))
            rp, ap = cap.gae[0]
            for p, r in ((rp, returns.reshape(-1)), (ap, adv.reshape(-1))):
                out["gae"] = max(out["gae"],
                                 gap(p, r.cpu(), rms(r.cpu())))
        data = R.learner.flatten_rollout(traj, returns, adv)
        perm = torch.randperm(steps * N, generator=gen, device=device)
        lr, ms = R.learner.update(policy, (ts.optimizer, ts.adapt_optimizer),
                                  lr, data, perm, args, rows)
        loss = float(ms.value_loss.mean() + ms.surrogate_loss.mean())
        ref_losses.append(loss)
        out["loss"] = max(out["loss"], abs(cap.losses[k] - loss)
                          / max(abs(loss), 1e-30))
        del cols, data, traj
    for h in hooks:
        h.remove()

    ranks = [dict(first_grad=cap.first_grad, params_after=cap.params_after,
                  losses=cap.losses)] + list(cap.replicas)
    for r in ranks[1:]:
        for loss, ref in zip(r["losses"], ref_losses, strict=True):
            out["loss"] = max(out["loss"], abs(loss - ref)
                              / max(abs(ref), 1e-30))
    out["grad"] = max(norm_gap(r["first_grad"], first_grad) for r in ranks)
    # a leaf's gradient: the larger of its first gradients under the two
    # optimisers (RMA's adaptation module gets none from the main loss)
    gn = {}
    for n, v in first_grad.items():
        leaf = n.split(":", 1)[1]
        gn[leaf] = max(gn.get(leaf, 0.0),
                       float(torch.linalg.vector_norm(v.double())))
    med = float(np.median(list(gn.values())))
    keep = [n for n, v in gn.items() if v >= ROUNDOFF_GRAD_SHARE * med]
    w0 = {n: v.cpu() for n, v in weights.items()}
    d_ref = {n: p.detach().cpu() - w0[n]
             for n, p in policy.named_parameters()}
    change = [leaf_gaps({n: r["params_after"][n] - w0[n]
                         for n in d_ref if n in r["params_after"]},
                        d_ref, keep) for r in ranks]
    out["change"] = max(max(g.values()) for g in change)
    # the steady forms of `loss` and `change` (PERF.md): the first
    # iteration's loss, before the KL-adaptive lr can branch apart, and
    # the median leaf's change
    out["loss_first"] = max(abs(r["losses"][0] - ref_losses[0])
                            / max(abs(ref_losses[0]), 1e-30) for r in ranks)
    out["change_median"] = max(float(np.median(list(g.values())))
                               for g in change)
    left_out = sorted(set(d_ref) - set(keep))
    return out, left_out


def numbers(cap, cell, device):
    """Every compared number of the run and the readings of a state left
    unchanged, from the capture of its first iterations."""
    R = job_mod.reference_side(cell.config)
    cfg = getattr(R.go1_config, cell.config["env_cfg"])(
        num_envs=int(cell.traffic["num_envs"]))
    ref_env = R.go1_env.LeggedRobotEnv(cfg, device=device)
    env_n, stale, worst = env_step_numbers(ref_env, R, cap.env_checks,
                                           device)
    del ref_env
    learn_n, left_out = learner_numbers(cap, cell, R, device)
    return {**env_n, **learn_n}, dict(stale=stale, change_left_out=left_out,
                                      worst=worst)


def verdict(nums: dict, limits: dict):
    """(correct, [(name, value, limit)]) with every limit's number: a
    number that is missing or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        v = nums.get(name, math.nan)
        rows.append((name, v, limit))
        ok = ok and math.isfinite(v) and v <= limit
    return ok, rows
