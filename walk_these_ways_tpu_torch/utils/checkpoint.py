"""Full-train-state checkpointing.

Counterpart of the JAX package's utils/checkpoint.py (`save`, `load`,
`restore_like`).  Unlike the reference, which checkpoints only the network
state_dict and the curriculum weights (reference:
go1_gym_learn/ppo_cse/__init__.py:231-274, 76-91 — env and optimizer state
are lost on resume), the complete training state is checkpointed: params,
both optimizer states, adaptive LR, env state (curriculum weights, DR
params), and the state of every `torch.Generator` (the JAX package carries
its RNG keys inside the env state; here they are generator states) — resume
is bit-exact.

Format: a pickle of nested dicts of numpy arrays, keyed like the port's
state (`utils/convert.train_state_to_numpy`, `env_state_to_numpy`).  No
torch object goes in the pickle.  The shared-storage (multi-host) layer of
the JAX package, `save_shared` / `load_shared`, belongs to the multi-device
slice of the port (ROADMAP item 22).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, torch.Generator):
        raise TypeError("a torch.Generator in a checkpoint tree: store its "
                        "get_state() as an array")
    return tree if tree is None or isinstance(tree, (str, bytes)) \
        else np.asarray(tree)


def save(path: str, tree) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(tree), f)
    os.replace(tmp, path)


def load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _keyed_leaves(tree, prefix=""):
    """{key path 'a/b/c': leaf} of a tree of nested dicts."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_keyed_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def restore_like(template, loaded, strict: bool = True):
    """Map loaded numpy arrays back onto the template's nested-dict
    structure.

    Leaves are matched BY KEY PATH (not position), and every matched leaf
    must agree with the template in shape — a checkpoint written before a
    state field was added/removed/reshaped fails loudly (or, with
    strict=False, keeps the template value for missing keys and ignores
    extra keys, printing what was migrated).  Leaves take the template's
    dtype."""
    t_map = _keyed_leaves(template)
    l_map = _keyed_leaves(loaded)
    missing = sorted(set(t_map) - set(l_map))
    extra = sorted(set(l_map) - set(t_map))
    if strict and (missing or extra):
        raise ValueError(
            "checkpoint/template structure mismatch:\n"
            f"  keys only in template (added since save?): {missing[:8]}\n"
            f"  keys only in checkpoint (removed since save?): {extra[:8]}\n"
            "pass strict=False to keep template values for missing keys "
            "and drop extra ones")
    bad_shape = [
        (k, np.shape(l_map[k]), np.shape(t_map[k]))
        for k in t_map if k in l_map
        and np.shape(l_map[k]) != np.shape(t_map[k])]
    if bad_shape:
        raise ValueError(
            "checkpoint leaf shapes do not match the template "
            "(different num_envs / model?): "
            + "; ".join(f"{k}: ckpt{s} vs template{t}"
                        for k, s, t in bad_shape[:8]))
    if missing or extra:
        print(f"restore_like: migrating checkpoint — keeping template "
              f"values for {missing}, ignoring {extra}", flush=True)

    def pick(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: pick(v, f"{prefix}{k}/") for k, v in tree.items()}
        key = prefix[:-1]
        if key not in l_map or tree is None:
            return tree
        dtype = getattr(tree, "dtype", None)
        return np.asarray(l_map[key], dtype=dtype)

    return pick(template)
