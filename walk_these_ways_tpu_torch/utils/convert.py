"""Carry weights, learner state and simulator state across from numpy arrays.

Everything here takes numpy only, so the arrays can come from the JAX
package (its parameter trees, optimizer states and EnvState leaves, after
`np.asarray`), from the committed `.npz` files, or from anywhere else.  Key
names are those of the JAX package's trees: `adaptation/w0`, `actor/b2`,
`std`, ... for the actor-critic (and for the Adam moments, which mirror the
parameters), and the EnvState / PhysicsState / CurriculumState / PallasOps
field names for the simulator state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..envs import curriculum as curr
from ..envs.go1_env import EnvState
from ..models.actor_critic import AC_Args, ActorCritic
from ..models.actuator_net import ActuatorNetParams
from ..physics.engine import PallasOps, PhysicsState


def _tensor(x, device, dtype=None):
    a = np.array(x)
    if dtype is None and a.dtype == np.float64:
        a = a.astype(np.float32)
    return torch.tensor(a, device=device, dtype=dtype)


def _mlp_keys(arrays: Mapping[str, np.ndarray], name: str):
    n = 0
    while f"{name}/w{n}" in arrays:
        n += 1
    return n


def actor_critic_from_numpy(arrays: Mapping[str, np.ndarray],
                            module: "ActorCritic | None" = None,
                            device="cuda") -> ActorCritic:
    """Load `adaptation/*`, `actor/*`, `critic/*` (w{i} (in, out), b{i}) and
    `std` into an ActorCritic.  With `module` given, only the keys present
    are loaded (the committed reference policy holds the adaptation module
    and `std` only); without it, all three MLPs must be present and the
    module is sized from them."""
    if module is None:
        for name in ("adaptation", "actor", "critic"):
            if _mlp_keys(arrays, name) == 0:
                raise KeyError(f"no '{name}/w0' in the arrays and no module "
                               "to load into")
        ad = [arrays[f"adaptation/w{i}"]
              for i in range(_mlp_keys(arrays, "adaptation"))]
        ac = [arrays[f"actor/w{i}"] for i in range(_mlp_keys(arrays, "actor"))]
        cr = [arrays[f"critic/w{i}"]
              for i in range(_mlp_keys(arrays, "critic"))]
        num_hist, num_priv = ad[0].shape[0], ad[-1].shape[1]
        num_actions = ac[-1].shape[1]
        args = AC_Args(
            actor_hidden_dims=tuple(w.shape[1] for w in ac[:-1]),
            critic_hidden_dims=tuple(w.shape[1] for w in cr[:-1]),
            adaptation_module_branch_hidden_dims=tuple(
                w.shape[1] for w in ad[:-1]))
        module = ActorCritic(0, num_priv, num_hist, num_actions, args,
                             device=device)
    dev = module.std.device
    with torch.no_grad():
        for name in ("adaptation", "actor", "critic"):
            mlp = getattr(module, name)
            n = _mlp_keys(arrays, name)
            if n == 0:
                continue
            if n != len(mlp.weights):
                raise ValueError(f"{name}: {n} layers given, module has "
                                 f"{len(mlp.weights)}")
            for i in range(n):
                w = _tensor(arrays[f"{name}/w{i}"], dev)
                b = _tensor(arrays[f"{name}/b{i}"], dev)
                if w.shape != mlp.weights[i].shape:
                    raise ValueError(f"{name}/w{i}: shape {tuple(w.shape)}, "
                                     f"module {tuple(mlp.weights[i].shape)}")
                mlp.weights[i].copy_(w)
                mlp.biases[i].copy_(b)
        if "std" in arrays:
            module.std.copy_(_tensor(arrays["std"], dev))
    return module


def actuator_net_from_numpy(arrays: Mapping[str, np.ndarray],
                            device="cuda") -> ActuatorNetParams:
    """w0 (32, 6), b0, w1 (32, 32), b1, w2 (1, 32), b2 -> ActuatorNetParams."""
    return ActuatorNetParams(*[arrays[k] for k in
                               ("w0", "b0", "w1", "b1", "w2", "b2")],
                             device=device)


def physics_state_from_numpy(arrays: Mapping[str, np.ndarray],
                             device="cuda") -> PhysicsState:
    return PhysicsState(**{k: _tensor(arrays[k], device)
                           for k in PhysicsState._fields})


def env_state_from_numpy(arrays: Mapping, generator: torch.Generator,
                         device="cuda") -> EnvState:
    """Every EnvState leaf from numpy: `arrays` maps the EnvState field
    names to arrays, with `phys`, `curriculum` and `curriculum_eval` (or
    None) as nested mappings of their own field names.  The random stream
    does not carry across: `generator` (on `device`) becomes the state's
    `rng`."""
    out = {}
    for name in EnvState._fields:
        if name == "rng":
            out[name] = generator
        elif name == "phys":
            out[name] = physics_state_from_numpy(arrays["phys"], device)
        elif name in ("curriculum", "curriculum_eval"):
            # the eval curriculum is None without an eval commands cfg
            c = arrays.get(name)
            out[name] = None if c is None else curr.CurriculumState(**{
                k: _tensor(c[k], device)
                for k in curr.CurriculumState._fields})
        else:
            out[name] = _tensor(arrays[name], device)
    return EnvState(**out)


def env_state_to_numpy(state: EnvState) -> dict:
    """Inverse of `env_state_from_numpy`: every leaf as numpy, `phys`,
    `curriculum` and `curriculum_eval` as nested dicts of their fields (the
    last None without an eval curriculum), and the state of the generator
    in `rng` (a uint8 array, `torch.Generator.get_state`)."""
    out = {}
    for name in EnvState._fields:
        v = getattr(state, name)
        if name == "rng":
            out[name] = v.get_state().numpy()
        elif v is None:
            out[name] = None
        elif name in ("phys", "curriculum", "curriculum_eval"):
            out[name] = {k: x.detach().cpu().numpy()
                         for k, x in v._asdict().items()}
        else:
            out[name] = v.detach().cpu().numpy()
    return out


def generator_from_state(state: np.ndarray, device="cuda") -> torch.Generator:
    """A generator on `device` continuing from a `get_state()` array."""
    g = torch.Generator(device=device)
    g.set_state(torch.from_numpy(np.asarray(state, np.uint8).copy()))
    return g


def cache_from_numpy(arrays: Mapping[str, np.ndarray], block: int = 256,
                     device="cuda") -> PallasOps:
    """The env-minor dynamics cache (physics/engine.PallasOps) from numpy:
    `arrays` maps the PallasOps tensor fields to arrays; `n_t` may be absent
    or None (flat ground)."""
    out = {}
    for name in PallasOps._fields:
        if name == "block":
            out[name] = int(block)
        elif name == "n_t":
            n_t = arrays.get("n_t")
            out[name] = None if n_t is None else _tensor(n_t, device)
        else:
            out[name] = _tensor(arrays[name], device).contiguous()
    return PallasOps(**out)


# the MLPs of each policy, in the order of the JAX package's parameter tree
_CSE_MLPS = ("adaptation", "actor", "critic")
_RMA_MLPS = ("encoder", "adaptation", "actor", "critic")


def rma_policy_from_numpy(arrays: Mapping[str, np.ndarray], device="cuda"):
    """An RMAPolicy (learn/ppo_rma.py) sized from and loaded with
    `encoder/*`, `adaptation/*`, `actor/*`, `critic/*` (w{i} (in, out),
    b{i}) and `std`: the JAX package's RMAParams, flattened."""
    from ..learn.ppo_rma import RMA_Args, RMAPolicy
    ws = {name: [arrays[f"{name}/w{i}"]
                 for i in range(_mlp_keys(arrays, name))]
          for name in _RMA_MLPS}
    for name, w in ws.items():
        if not w:
            raise KeyError(f"no '{name}/w0' in the arrays")
    latent = ws["encoder"][-1].shape[1]
    args = RMA_Args(
        actor_hidden_dims=tuple(w.shape[1] for w in ws["actor"][:-1]),
        critic_hidden_dims=tuple(w.shape[1] for w in ws["critic"][:-1]),
        encoder_hidden_dims=tuple(w.shape[1] for w in ws["encoder"][:-1]),
        adaptation_hidden_dims=tuple(
            w.shape[1] for w in ws["adaptation"][:-1]),
        latent_dim=latent)
    policy = RMAPolicy(ws["actor"][0].shape[0] - latent,
                       ws["encoder"][0].shape[0],
                       ws["adaptation"][0].shape[0],
                       ws["actor"][-1].shape[1], args, device=device)
    with torch.no_grad():
        for key, p in _param_names(policy):
            x = _tensor(arrays[key], p.device)
            if x.shape != p.shape:
                raise ValueError(f"{key}: shape {tuple(x.shape)}, module "
                                 f"{tuple(p.shape)}")
            p.copy_(x)
    return policy


def _param_names(policy):
    """[(key in the JAX package's tree, parameter)] of an ActorCritic or an
    RMAPolicy."""
    out = []
    for name in (_RMA_MLPS if hasattr(policy, "encoder") else _CSE_MLPS):
        mlp = getattr(policy, name)
        for i, (w, b) in enumerate(zip(mlp.weights, mlp.biases)):
            out += [(f"{name}/w{i}", w), (f"{name}/b{i}", b)]
    return out + [("std", policy.std)]


def _set_adam_state(opt, named_params, moments: Mapping, device):
    """Load `count`, `mu/<key>`, `nu/<key>` into a torch.optim.Adam."""
    count = float(np.asarray(moments["count"]))
    for key, p in named_params:
        opt.state[p] = dict(
            step=torch.tensor(count, dtype=torch.float32),
            exp_avg=_tensor(moments["mu"][key], device),
            exp_avg_sq=_tensor(moments["nu"][key], device))
        for k in ("exp_avg", "exp_avg_sq"):
            if opt.state[p][k].shape != p.shape:
                raise ValueError(f"{key}: moment shape "
                                 f"{tuple(opt.state[p][k].shape)}, parameter "
                                 f"{tuple(p.shape)}")


def train_state_from_numpy(arrays: Mapping, generator: torch.Generator,
                           args=None, device="cuda"):
    """The learner's state (learn/ppo.TrainState) from numpy:

        arrays = {"params":    {"adaptation/w0": ..., ..., "std": ...},
                  "opt":       {"count": n, "mu": {<param keys>}, "nu": {...}},
                  "adapt_opt": {"count": n, "mu": {"adaptation/w0": ...},
                                "nu": {...}},
                  "lr": float, "iteration": int}

    `opt` is the main Adam over all parameters, `adapt_opt` the second Adam
    over the adaptation module; `mu` / `nu` / `count` are the first and
    second moments and the step count (optax's names).  The random stream
    does not carry across: `generator` becomes the state's `rng`."""
    from ..learn import ppo
    policy = actor_critic_from_numpy(arrays["params"], device=device)
    return _train_state(ppo.TrainState, policy, arrays, generator, args,
                        device)


def rma_train_state_from_numpy(arrays: Mapping, generator: torch.Generator,
                               args=None, device="cuda"):
    """The RMA learner's state (learn/ppo_rma.RMATrainState) from numpy, in
    `train_state_from_numpy`'s layout: `params` holds the JAX package's
    RMAParams flattened (`encoder/*`, `adaptation/*`, `actor/*`,
    `critic/*`, `std`); `opt` is the main Adam over all of them (the
    adaptation module's moments included), `adapt_opt` the second Adam over
    the adaptation module."""
    from ..learn import ppo_rma
    policy = rma_policy_from_numpy(arrays["params"], device=device)
    return _train_state(ppo_rma.RMATrainState, policy, arrays, generator,
                        args, device)


def _train_state(cls, policy, arrays, generator, args, device):
    from ..learn import ppo
    args = args or ppo.PPO_Args()
    main_opt, adapt_opt = ppo.make_optimizers(policy, args)
    named = _param_names(policy)
    _set_adam_state(main_opt, named, arrays["opt"], device)
    _set_adam_state(adapt_opt,
                    [(k, p) for k, p in named if k.startswith("adaptation/")],
                    arrays["adapt_opt"], device)
    lr = float(np.float32(arrays["lr"]))
    for group in main_opt.param_groups:
        group["lr"] = lr
    return cls(policy=policy, optimizer=main_opt, adapt_optimizer=adapt_opt,
               lr=lr, rng=generator, iteration=int(arrays.get("iteration", 0)))


def train_state_to_numpy(ts) -> dict:
    """Inverse of `train_state_from_numpy` and of
    `rma_train_state_from_numpy` (the generator is left out).  A parameter
    the optimizer has not stepped yet has zero moments."""
    named = _param_names(ts.policy)

    def moments(opt, names):
        out = dict(count=0, mu={}, nu={})
        for key, p in names:
            st = opt.state.get(p, {})
            out["count"] = int(st["step"]) if "step" in st else out["count"]
            for dst, src in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                out[dst][key] = (st[src].detach().cpu().numpy() if src in st
                                 else np.zeros(tuple(p.shape), np.float32))
        return out

    return dict(
        params={k: p.detach().cpu().numpy() for k, p in named},
        opt=moments(ts.optimizer, named),
        adapt_opt=moments(ts.adapt_optimizer,
                          [(k, p) for k, p in named
                           if k.startswith("adaptation/")]),
        lr=float(ts.lr), iteration=int(ts.iteration))


rma_train_state_to_numpy = train_state_to_numpy
