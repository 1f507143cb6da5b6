"""Carry weights and simulator state across from numpy arrays.

Everything here takes numpy only, so the arrays can come from the JAX
package (its parameter trees and EnvState leaves, after `np.asarray`), from
the committed `.npz` files, or from anywhere else.  Key names are those of
the JAX package's trees: `adaptation/w0`, `actor/b2`, `std`, ... for the
actor-critic, and the EnvState / PhysicsState / CurriculumState field names
for the simulator state.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..envs import curriculum as curr
from ..envs.go1_env import EnvState
from ..models.actor_critic import AC_Args, ActorCritic
from ..models.actuator_net import ActuatorNetParams
from ..physics.engine import PhysicsState


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
    names to arrays, with `phys` and `curriculum` as nested mappings of
    their own field names.  The random stream does not carry across:
    `generator` (on `device`) becomes the state's `rng`."""
    out = {}
    for name in EnvState._fields:
        if name == "rng":
            out[name] = generator
        elif name == "phys":
            out[name] = physics_state_from_numpy(arrays["phys"], device)
        elif name == "curriculum":
            out[name] = curr.CurriculumState(**{
                k: _tensor(arrays["curriculum"][k], device)
                for k in curr.CurriculumState._fields})
        elif name == "curriculum_eval":
            if arrays.get("curriculum_eval") is not None:
                raise NotImplementedError(
                    "the eval curriculum belongs to the evaluation slice")
            out[name] = None
        else:
            out[name] = _tensor(arrays[name], device)
    return EnvState(**out)
