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
torch object goes in the pickle.

Shared storage (the JAX package's `save_shared` / `load_shared`, there on
orbax): a DIRECTORY that every rank of an env mesh (parallel/mesh.py)
writes its own part of, and any mesh can resume from.  Each rank writes
its env rows (`rank_<r>.pkl`), rank 0 the leaves that are one value for
the whole batch (`replicated.pkl`: the learner state, the curriculum, the
generators' states, which every rank holds alike) and `manifest.json`
(world size, the global train and eval env counts, each split leaf's env
axis).  `load_shared` reassembles the global arrays and takes the live
mesh's rows, so a checkpoint of 2 ranks resumes on 1 and the other way
round (on the mesh that wrote it each rank reads back its own file, bit
for bit).  An overwrite is crash-safe: the new checkpoint is written next to
the old one (`<dir>.new`), and after a barrier rank 0 swaps it in by
rename (`<dir>` to `<dir>.old`, `<dir>.new` to `<dir>`, `<dir>.old`
removed), then a second barrier, so the previous resume point survives a
preemption mid-save.  Every part is written whole or not at all (a
temporary file renamed into place), and rank 0 swaps only when every
rank's part is in `<dir>.new`: a barrier that did not wait raises there
instead of committing a partial checkpoint.  Only local and shared file
systems: a `scheme://` path raises.
"""
from __future__ import annotations

import json
import os
import pickle
import shutil

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


def _shared_path(path: str) -> str:
    """The absolute local directory of a shared checkpoint; a URL raises
    (no remote store is reachable from the port's machines)."""
    if "://" in path:
        raise ValueError(f"shared checkpoint {path!r}: only local or shared "
                         "file system paths, not a remote store")
    return os.path.abspath(path)


def _dump(path: str, obj) -> None:
    """Pickle `obj` to `path` whole or not at all: a file there is
    complete."""
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f)
    os.replace(path + ".tmp", path)


# the top-level keys of a checkpoint tree whose leaves may hold env rows
# (learn/runner.Runner's layout)
_SHARDED = ("env_state", "obs_dict")


def save_shared(path: str, tree, rows=None) -> None:
    """Commit `tree` (nested dicts; torch or numpy leaves) to the shared
    directory `path`.  With `rows` (the env's parallel/mesh.EnvRows) every
    rank of its mesh calls this with its own tree: each writes its env rows
    of the leaves under `_SHARDED` that have them (parallel/mesh.env_axis)
    and rank 0 the rest; without, the whole tree is one value.  Crash-safe
    overwrite (module docstring)."""
    from ..parallel import mesh as mesh_mod

    path = _shared_path(path)
    mesh = rows.mesh if rows is not None else mesh_mod.EnvMesh()
    new, old = path + ".new", path + ".old"
    flat = _keyed_leaves(_to_numpy(tree))
    axes = {}
    for k, v in flat.items():
        names = k.split("/")
        if rows is not None and names[0] in _SHARDED:
            ax = mesh_mod.env_axis(names[1:], v, rows.n)
            if ax is not None:
                axes[k] = ax
    if mesh.rank == 0:
        shutil.rmtree(new, ignore_errors=True)
        shutil.rmtree(old, ignore_errors=True)
        os.makedirs(new)
    mesh.barrier()
    _dump(os.path.join(new, f"rank_{mesh.rank:05d}.pkl"),
          {k: v for k, v in flat.items() if k in axes})
    if mesh.rank == 0:
        _dump(os.path.join(new, "replicated.pkl"),
              {k: v for k, v in flat.items() if k not in axes})
        with open(os.path.join(new, "manifest.json"), "w") as f:
            json.dump(dict(
                world_size=mesh.world_size,
                num_envs=rows.num_train if rows is not None else 0,
                num_eval_envs=rows.num_eval if rows is not None else 0,
                env_axes=axes), f, indent=1)
    mesh.barrier()
    if mesh.rank == 0:
        missing = [f for f in [f"rank_{r:05d}.pkl"
                               for r in range(mesh.world_size)]
                   if not os.path.exists(os.path.join(new, f))]
        if missing:
            raise RuntimeError(
                f"shared checkpoint {path}: {missing} not written when rank "
                "0 came to swap it in (the barrier did not wait for every "
                "rank); the previous checkpoint is kept")
        if os.path.exists(path):
            os.rename(path, old)
        os.rename(new, path)
        shutil.rmtree(old, ignore_errors=True)
    # no rank reads the directory before rank 0's swap has landed
    mesh.barrier()


def load_shared(path: str, template, rows=None):
    """Restore a `save_shared` directory onto `template`'s structure
    (nested dicts, numpy leaves in the template's dtypes), as
    `restore_like` does: the global arrays reassembled from every saved
    rank's rows and the live mesh's rows taken (`rows`; the whole batch
    without).  A structure or shape drift raises, as does a checkpoint of
    other global env counts."""
    from ..parallel import mesh as mesh_mod

    path = _shared_path(path)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    flat = dict(load(os.path.join(path, "replicated.pkl")))
    if man["env_axes"]:
        T, E, W = man["num_envs"], man["num_eval_envs"], man["world_size"]
        if rows is None:
            rows = mesh_mod.env_rows(None, T, E)
        if (rows.num_train, rows.num_eval) != (T, E):
            raise ValueError(
                f"shared checkpoint of {T} + {E} envs, the live env has "
                f"{rows.num_train} + {rows.num_eval}")
        if W == rows.mesh.world_size:
            # the same mesh: each rank's rows as it wrote them, bit for bit
            # (the padded env-minor lanes too)
            flat.update(load(os.path.join(
                path, f"rank_{rows.mesh.rank:05d}.pkl")))
            return _restore_keyed(template, flat, strict=True)
        parts = [load(os.path.join(path, f"rank_{r:05d}.pkl"))
                 for r in range(W)]
        t, n = T // W, (T + E) // W
        for k, ax in man["env_axes"].items():
            cut = [p[k][..., :n] if ax == -1 else p[k] for p in parts]
            lead = (slice(None),) * (ax % cut[0].ndim)
            full = np.concatenate([c[lead + (slice(0, t),)] for c in cut]
                                  + [c[lead + (slice(t, n),)] for c in cut],
                                  axis=ax)
            mine = rows.take(full, axis=ax)
            flat[k] = mesh_mod.pad_env_minor(mine, rows.n) if ax == -1 \
                else mine
    return _restore_keyed(template, flat, strict=True)


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
    return _restore_keyed(template, _keyed_leaves(loaded), strict)


def _restore_keyed(template, l_map, strict: bool = True):
    """`restore_like` on the loaded leaves keyed by their paths."""
    t_map = _keyed_leaves(template)
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
