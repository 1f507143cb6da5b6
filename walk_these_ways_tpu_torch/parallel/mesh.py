"""Env-axis data parallelism over torch.distributed.

Counterpart of the JAX package's parallel/mesh.py: a 1-D mesh over the
``env`` axis, env-state tensors split on their env axis, learner state
replicated.  JAX's GSPMD keeps the global program's meaning and inserts the
collectives; here each rank is a process that holds its rows of the envs
and steps them through its own kernel launches, and the global program's
collectives are written out where it has them:

- every random draw takes the global shape from a generator that is the
  same on every rank, and the rank keeps its rows (`EnvRows.take`), so a
  run on W ranks draws what the 1-rank run draws (JAX's partitionable
  threefry gives each shard the rows of the unsharded draw);
- the curriculum update sees every env (`EnvRows.gather`), the reward
  terms' signs come from their sums over every env, GAE normalises over
  the whole batch, the PPO minibatches are the global permutation's, and
  the gradients, the mean KL and the logged metrics are summed over the
  ranks (`all_reduce_sum`).

Only `all_reduce(SUM)` and `broadcast` are used: they are what gloo offers
on CUDA tensors (two ranks sharing one card must use gloo, NCCL refuses
two ranks on one device), and NCCL has both.  A gather of env rows is the
sum of a tensor of the global shape filled with -0.0, into which each rank
wrote its own rows: x + (-0.0) is x for every x, -0.0 and NaN included.

A run on W ranks computes what the 1-rank run computes up to the order of
its reductions; with a mesh of one rank every function here is the
identity and no collective is made.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..physics.engine import MEGASTEP_BLOCK

# the launcher's variables (`torchrun` sets all five)
ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# seconds a collective may wait for the other ranks
TIMEOUT_S = 600.0
# EnvState fields that are one value for the whole batch, never split
_WHOLE = frozenset(("rng", "common_step", "gravity_offset", "curriculum",
                    "curriculum_eval"))
# EnvState fields whose env axis is the last one, padded to a multiple of
# the control-step kernel's block
_ENV_MINOR = frozenset(("contact_lam_t",))


@dataclasses.dataclass(frozen=True)
class EnvMesh:
    """This process's place on the env axis: its rank of `world_size`, its
    device, the process group (None for one rank) and its backend."""
    rank: int = 0
    world_size: int = 1
    device: torch.device = torch.device("cpu")
    group: object = None
    backend: Optional[str] = None
    axis: str = "env"

    @property
    def distributed(self) -> bool:
        return self.world_size > 1

    def __repr__(self):
        return (f"EnvMesh(axis={self.axis!r}, rank={self.rank}, "
                f"world_size={self.world_size}, device={self.device}, "
                f"backend={self.backend})")

    def barrier(self):
        """Every rank's host waits here for the others: an all-reduce (gloo
        and NCCL both have it on the mesh's device) whose result is read,
        since an NCCL collective returns before it has run."""
        if self.distributed:
            done = torch.zeros(1, device=self.device)
            dist.all_reduce(done, group=self.group)
            done.item()


def _local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE",
                              os.environ.get("WORLD_SIZE", "1")))


def _rank_device(device) -> torch.device:
    """The card of this process: LOCAL_RANK's own when the host has a card
    for every local rank, else the ranks share them round robin."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("the env mesh runs on CUDA devices: "
                           "torch.cuda.is_available() is False (pass "
                           "device='cpu' to run on the CPU)")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device, backend: Optional[str] = None) -> str:
    """NCCL when the tensors are on CUDA devices and every local rank has a
    card of its own; gloo when ranks share a card or the tensors are on the
    CPU.  A backend asked for that cannot serve raises."""
    dev = torch.device(device)
    shared = (dev.type == "cuda"
              and _local_world_size() > torch.cuda.device_count())
    auto = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if backend is None:
        backend = auto
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' needs CUDA tensors; the mesh's "
                             f"device is {dev}")
        if shared:
            raise ValueError(
                f"backend 'nccl' refuses two ranks on one device: "
                f"{_local_world_size()} local ranks on "
                f"{torch.cuda.device_count()} cards (use 'gloo')")
        if not dist.is_nccl_available():
            raise ValueError("backend 'nccl' is not built into this torch")
    elif backend == "gloo":
        if not dist.is_gloo_available():
            raise ValueError("backend 'gloo' is not built into this torch")
    else:
        raise ValueError(f"unknown backend {backend!r} (want 'nccl' or "
                         "'gloo')")
    return backend


def maybe_init_distributed(device="cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group that the launcher's variables describe
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as `torchrun`
    sets them).  Without them, or when a group is already up, it does
    nothing, so the same command runs on one card and on several.
    Returns whether it joined."""
    if dist.is_initialized() or not all(k in os.environ for k in ENV_VARS):
        return False
    dev = _rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        choose_backend(dev, backend), init_method="env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def make_mesh(n_devices: Optional[int] = None, axis: str = "env",
              device=None, backend: Optional[str] = None) -> EnvMesh:
    """The env mesh over the process group, or a mesh of one rank when no
    group is up.  `device` defaults to this rank's card; `backend`, if
    given, must be the group's."""
    dev = _rank_device("cuda" if device is None else device)
    if not dist.is_initialized():
        launched = int(os.environ.get("WORLD_SIZE", "1"))
        if launched > 1:
            # every process would train every env as rank 0 of its own
            raise RuntimeError(
                f"WORLD_SIZE={launched} is set but this process joined no "
                "process group: call maybe_init_distributed() first")
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} ranks needs a process "
                             "group (maybe_init_distributed)")
        if backend is not None:
            choose_backend(dev, backend)
        return EnvMesh(device=dev, axis=axis)
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"the process group has {world} ranks, not "
                         f"{n_devices}")
    have = dist.get_backend()
    if backend is not None and backend != have:
        raise ValueError(f"backend {backend!r} asked for, the process group "
                         f"runs {have!r}")
    if have == "nccl":
        choose_backend(dev, "nccl")
    # one collective on the mesh's device: the backend serves it here or
    # the mesh is refused now, not in the first training step
    probe = torch.ones(1, device=dev)
    dist.all_reduce(probe, group=dist.group.WORLD)
    if int(probe.item()) != world:
        raise RuntimeError(f"the {have} group summed {probe.item()} over "
                           f"{world} ranks")
    return EnvMesh(rank=dist.get_rank(), world_size=world, device=dev,
                   group=dist.group.WORLD, backend=have, axis=axis)


# -- collectives ---------------------------------------------------------------


def _wire(x: torch.Tensor) -> torch.Tensor:
    """The dtype a tensor travels as: bools as uint8."""
    return x.to(torch.uint8) if x.dtype == torch.bool else x


def _packed(tensors, mesh: EnvMesh):
    """[(indices, one flat buffer of those tensors on the mesh's device)],
    one for each dtype the tensors travel as."""
    groups = {}
    for i, x in enumerate(tensors):
        groups.setdefault(_wire(x).dtype, []).append(i)
    return [(idx, torch.cat([_wire(tensors[i]).reshape(-1).to(mesh.device)
                             for i in idx])) for idx in groups.values()]


def _parts(tensors, idx, buf):
    """(i, tensor i's part of `buf`, in its shape) for i in `idx`."""
    k = 0
    for i in idx:
        n = tensors[i].numel()
        yield i, buf[k:k + n].reshape(tensors[i].shape)
        k += n


def all_reduce_sum(tensors, mesh: "EnvMesh | None"):
    """Each tensor summed over the ranks, in one collective per dtype (the
    tensors flattened into one buffer on the mesh's device).  Returns new
    tensors on the inputs' devices; the inputs themselves without a
    distributed mesh."""
    tensors = list(tensors)
    if mesh is None or not mesh.distributed:
        return tensors
    out = [None] * len(tensors)
    for idx, buf in _packed(tensors, mesh):
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        for i, part in _parts(tensors, idx, buf):
            out[i] = part.to(device=tensors[i].device,
                             dtype=tensors[i].dtype)
    return out


def broadcast_(tensors, mesh: "EnvMesh | None", src: int = 0):
    """Overwrite each tensor with rank `src`'s, in one collective per
    dtype."""
    tensors = list(tensors)
    if mesh is None or not mesh.distributed:
        return tensors
    for idx, buf in _packed(tensors, mesh):
        dist.broadcast(buf, src=src, group=mesh.group)
        with torch.no_grad():
            for i, part in _parts(tensors, idx, buf):
                tensors[i].copy_(part.to(tensors[i].dtype))
    return tensors


# -- the env rows of a rank ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EnvRows:
    """Rank r's rows of the global batch of `num_train` train envs followed
    by `num_eval` eval envs: train rows [r t, (r + 1) t) and eval rows
    num_train + [r e, (r + 1) e), with t = num_train / W and e = num_eval /
    W; locally they are laid out as [its train rows | its eval rows].  The
    one map from local rows to global rows: every draw, gather, shard and
    checkpoint goes through it.  All of it is integer arithmetic."""
    mesh: EnvMesh
    num_train: int
    num_eval: int = 0

    def __post_init__(self):
        w = self.mesh.world_size
        for name, n in (("num_envs", self.num_train),
                        ("num_eval_envs", self.num_eval)):
            if n % w:
                raise ValueError(f"{name} = {n} does not divide over the "
                                 f"{w} ranks of the env mesh")

    @property
    def distributed(self) -> bool:
        return self.mesh.distributed

    @property
    def t(self) -> int:
        return self.num_train // self.mesh.world_size

    @property
    def e(self) -> int:
        return self.num_eval // self.mesh.world_size

    @property
    def n(self) -> int:
        """This rank's envs."""
        return self.t + self.e

    @property
    def num_envs(self) -> int:
        """The global batch's envs."""
        return self.num_train + self.num_eval

    @property
    def train(self) -> slice:
        """This rank's train rows, within the train envs."""
        r = self.mesh.rank
        return slice(r * self.t, (r + 1) * self.t)

    @property
    def eval(self) -> slice:
        """This rank's eval rows, within the eval envs."""
        r = self.mesh.rank
        return slice(r * self.e, (r + 1) * self.e)

    def global_index(self) -> np.ndarray:
        """The global row of each local row."""
        return np.concatenate([np.arange(self.num_train)[self.train],
                               self.num_train
                               + np.arange(self.num_eval)[self.eval]])

    def take(self, x, axis: int = 0):
        """This rank's rows of a global batch (torch or numpy) along
        `axis`; the batch itself on a mesh of one rank."""
        if not self.distributed:
            return x
        ax = axis % x.ndim
        lead = (slice(None),) * ax
        tr = x[lead + (self.train,)]
        if not self.num_eval:
            return tr
        ev = x[lead + (slice(self.num_train + self.eval.start,
                             self.num_train + self.eval.stop),)]
        if isinstance(x, np.ndarray):
            return np.concatenate([tr, ev], axis=ax)
        return torch.cat([tr, ev], dim=ax)

    def train_only(self) -> "EnvRows":
        """The rows of the train envs alone (a tensor of the rank's train
        rows, gathered)."""
        return EnvRows(self.mesh, self.num_train)

    def take_train(self, x):
        """This rank's rows of a batch of the train envs alone."""
        return x[self.train] if self.distributed else x

    def take_eval(self, x):
        """This rank's rows of a batch of the eval envs alone."""
        return x[self.eval] if self.distributed else x

    def train_draw(self) -> "tuple[int, slice]":
        """(the train envs, this rank's rows of them): what a draw over
        the train envs keeps."""
        return self.num_train, self.train

    def _scatter(self, x, axis: int):
        """A tensor of the global shape along `axis`, -0.0 (or 0) but for
        this rank's rows, which hold `x`."""
        ax = axis % x.ndim
        x = _wire(x)
        shape = list(x.shape)
        shape[ax] = self.num_envs
        buf = torch.full(shape, -0.0, dtype=x.dtype, device=x.device) \
            if x.dtype.is_floating_point else \
            torch.zeros(shape, dtype=x.dtype, device=x.device)
        lead = (slice(None),) * ax
        buf[lead + (self.train,)] = x[lead + (slice(0, self.t),)]
        if self.num_eval:
            buf[lead + (slice(self.num_train + self.eval.start,
                              self.num_train + self.eval.stop),)] = \
                x[lead + (slice(self.t, self.n),)]
        return buf

    def gather(self, tensors, axis: int = 0):
        """The global batches of local ones (torch), in one collective per
        dtype; every rank gets them.  The tensors themselves on a mesh of
        one rank."""
        tensors = list(tensors)
        if not self.distributed:
            return tensors
        out = all_reduce_sum([self._scatter(x, axis) for x in tensors],
                             self.mesh)
        return [o.to(torch.bool) if x.dtype == torch.bool else o
                for o, x in zip(out, tensors)]

    def all_reduce_sum(self, tensors):
        return all_reduce_sum(tensors, self.mesh)


def env_rows(mesh: "EnvMesh | None", num_envs: int,
             num_eval_envs: int = 0) -> EnvRows:
    """Rank r's block of the global env rows (`EnvRows`); a mesh of one
    rank when `mesh` is None."""
    return EnvRows(mesh if mesh is not None else EnvMesh(), num_envs,
                   num_eval_envs)


# -- trees of env state --------------------------------------------------------


def pad_env_minor(x, n: int):
    """`x` cut to `n` along its last axis and zero-padded to the kernel's
    block."""
    npad = -(-n // MEGASTEP_BLOCK) * MEGASTEP_BLOCK
    x = x[..., :n]
    if isinstance(x, np.ndarray):
        return np.concatenate(
            [x, np.zeros(x.shape[:-1] + (npad - n,), x.dtype)], axis=-1)
    return torch.nn.functional.pad(x, (0, npad - n))


def env_axis(name, x, n: int):
    """The env axis of leaf `name` (a field name, or the path of names to
    it) in a batch of `n` envs: -1 for the env-minor (padded) leaves, 0 for
    a leaf whose leading dimension is `n`, None for a leaf that is one
    value for the whole batch."""
    names = [name] if isinstance(name, str) else list(name)
    if any(k in _WHOLE for k in names) or not hasattr(x, "shape"):
        return None
    if names and names[-1] in _ENV_MINOR:
        return -1
    return 0 if len(x.shape) >= 1 and x.shape[0] == n else None


def _map(tree, fn, name=""):
    """`fn(name, leaf)` over a tree of NamedTuples, dicts, tuples and
    lists; a leaf's name is its field's or key's (a subtree's whole-batch
    name is kept whole)."""
    if name in _WHOLE:
        return tree
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(v, fn, k)
                            for k, v in zip(tree._fields, tree)])
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, name) for v in tree)
    return fn(name, tree)


def shard_env_state(tree, rows: EnvRows):
    """This rank's rows of every leaf of a global tree (an EnvState, an obs
    dict, their numpy forms): the leaves whose leading dimension is the
    global env count (the JAX rule), and the env-minor leaves
    (`contact_lam_t`, (P, 3, Npad)) along their last axis, re-padded to the
    local Npad.  Every other leaf is kept whole."""
    if not rows.distributed:
        return tree

    def take(name, x):
        ax = env_axis(name, x, rows.num_envs)
        if ax is None:
            return x
        if ax == -1:
            return pad_env_minor(rows.take(x[..., :rows.num_envs], axis=-1),
                             rows.n)
        return rows.take(x)

    return _map(tree, take)


def gather_env_state(tree, rows: EnvRows):
    """The inverse of `shard_env_state` (torch leaves): every rank gets the
    global tree, in one collective per dtype."""
    if not rows.distributed:
        return tree
    found = []

    def collect(name, x):
        ax = env_axis(name, x, rows.n)
        if ax is not None:
            found.append((x[..., :rows.n] if ax == -1 else x, ax))
        return x

    _map(tree, collect)
    by_axis = {0: [], -1: []}
    for i, (x, ax) in enumerate(found):
        by_axis[ax].append(i)
    full = [None] * len(found)
    for ax, idx in by_axis.items():
        for i, g in zip(idx, rows.gather([found[i][0] for i in idx], ax)):
            full[i] = g
    it = iter(full)

    def put(name, x):
        ax = env_axis(name, x, rows.n)
        if ax is None:
            return x
        g = next(it)
        return pad_env_minor(g, rows.num_envs) if ax == -1 else g

    return _map(tree, put)


def replicate(ts, mesh: "EnvMesh | None"):
    """Every rank takes rank 0's learner state: the policy's parameters,
    both optimizers' moments and step counts, the learning rate, the
    iteration and the generator's state, in one broadcast per dtype.  Works
    on learn/ppo.TrainState and learn/ppo_rma.RMATrainState in place and
    returns it."""
    if mesh is None or not mesh.distributed:
        return ts
    tensors = [p.data for p in ts.policy.parameters()]
    for opt in (ts.optimizer, ts.adapt_optimizer):
        for p in (p for g in opt.param_groups for p in g["params"]):
            for k in sorted(opt.state.get(p, {})):
                if isinstance(opt.state[p][k], torch.Tensor):
                    tensors.append(opt.state[p][k])
    gen_state = ts.rng.get_state()
    scalars = torch.tensor([float(ts.lr), float(ts.iteration)],
                           dtype=torch.float64)
    broadcast_(tensors + [gen_state, scalars], mesh)
    ts.rng.set_state(gen_state)
    ts.lr = float(np.float32(scalars[0].item()))
    ts.iteration = int(scalars[1].item())
    return ts
