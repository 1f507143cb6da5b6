"""Frozen copy of walk_these_ways_tpu_torch/parallel/mesh.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Env-axis data parallelism over torch.distributed.  The copy keeps what
one rank runs: `EnvRows`, the rows of the global batch that a rank holds
(all of them here), and the one-rank forms of the collectives, which
return their inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


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


# -- collectives ---------------------------------------------------------------


def all_reduce_sum(tensors, mesh: "EnvMesh | None"):
    """Each tensor summed over the ranks: the tensors themselves, as the
    reference runs one rank."""
    if mesh is not None and mesh.distributed:
        raise ValueError("the reference runs one rank")
    return list(tensors)


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


    def train_draw(self) -> "tuple[int, slice]":
        """(the train envs, this rank's rows of them): what a draw over
        the train envs keeps."""
        return self.num_train, self.train


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
