"""Trajectory split/pad utilities for recurrent policies.

Counterpart of the JAX package's learn/traj_utils.py (reference:
go1_gym_learn/utils/utils.py:5-43 `split_and_pad_trajectories` /
`unpad_trajectories`, consumed by the recurrent minibatch generator at
go1_gym_learn/ppo_cse/rollout_storage.py:142-180; the default MoB config
uses none of them, but they are part of the trainer's surface).

The split is index arithmetic on tensors plus one scatter:

- segment id per (t, env)   = exclusive cumsum of dones down the column
- trajectory id             = env-major base offset + segment id
- position inside segment   = t - (last done index before t + 1)
- padded output             = zeros; padded[pos, traj] = x   (one scatter)
- valid mask                = zeros; masks[pos, traj] = True

Trajectories are numbered env-major, in time order within each env
(utils.py:24-32 flattens env-major before splitting).  With an explicit
`max_num_trajs` M below the true count, the trajectories numbered M and
above are dropped, as the JAX scatter's `mode="drop"` drops them; `T * N`
always bounds the count.
"""
from __future__ import annotations

import torch


def _traj_indices(dones: torch.Tensor):
    """(T, N) dones -> (traj_idx, pos, num_trajs) with env-major trajectory
    numbering.  The last step always ends a trajectory (utils.py:22-23
    `dones[-1] = 1`)."""
    T, N = dones.shape
    d = dones.to(torch.int64).clone()
    d[-1, :] = 1
    # segment id = number of dones strictly before t in this column
    seg = torch.cumsum(d, dim=0) - d
    counts = seg[-1, :] + 1                       # trajectories per env
    base = torch.cumsum(counts, dim=0) - counts   # exclusive env-major base
    traj_idx = base[None, :] + seg                # (T, N)
    # start of the current segment = (last done index before t) + 1, a
    # running maximum of (t + 1) over the done rows
    t_col = torch.arange(T, dtype=torch.int64, device=dones.device)[:, None]
    done_pos = torch.where(d > 0, t_col + 1, torch.zeros_like(d))
    start = torch.cat([torch.zeros((1, N), dtype=torch.int64,
                                   device=dones.device),
                       torch.cummax(done_pos, dim=0).values[:-1]], dim=0)
    pos = t_col - start                           # (T, N)
    return traj_idx, pos, counts.sum()


def split_and_pad_trajectories(x: torch.Tensor, dones: torch.Tensor,
                               max_num_trajs: int | None = None):
    """Split (T, N, ...) at dones into zero-padded (T, M, ...) trajectories
    plus a (T, M) validity mask (reference utils.py:5-37).

    `max_num_trajs` is M; None takes the true count (one host read).  Rows
    past a trajectory's length are zero / False, so the result is the
    reference's `pad_sequence` output padded out to T rows."""
    T, N = dones.shape[:2]
    dones = dones.reshape(T, N)
    traj_idx, pos, num = _traj_indices(dones)
    M = int(num.item()) if max_num_trajs is None else int(max_num_trajs)
    flat_t = pos.reshape(-1)
    flat_m = traj_idx.reshape(-1)
    feat = tuple(x.shape[2:])
    # index_put_ raises on an index out of bounds: keep only the entries of
    # the trajectories below M (the JAX scatter's mode="drop")
    keep = flat_m < M
    flat_t, flat_m = flat_t[keep], flat_m[keep]
    padded = torch.zeros((T, M) + feat, dtype=x.dtype, device=x.device)
    padded[flat_t, flat_m] = x.reshape((T * N,) + feat)[keep]
    masks = torch.zeros((T, M), dtype=torch.bool, device=x.device)
    masks[flat_t, flat_m] = True
    return padded, masks


def unpad_trajectories(padded: torch.Tensor, dones: torch.Tensor):
    """Inverse of split_and_pad_trajectories: gather (T, M, ...) padded
    trajectories back to (T, N, ...) env-major time series (reference
    utils.py:39-43 takes the masks; the (t, env) -> (pos, traj) map is
    recomputed from dones here, which is the same information)."""
    T, N = dones.shape[:2]
    traj_idx, pos, _ = _traj_indices(dones.reshape(T, N))
    return padded[pos.reshape(-1), traj_idx.reshape(-1)].reshape(
        (T, N) + tuple(padded.shape[2:]))


def recurrent_minibatches(traj_fields, seq_fields, dones, num_mini_batches,
                          max_num_trajs: int | None = None):
    """Yield RNN-style minibatches (reference rollout_storage.py:142-180
    `reccurent_mini_batch_generator`, one epoch): the envs are split into
    `num_mini_batches` contiguous groups; `traj_fields` entries come back
    split-and-padded per trajectory with a shared validity mask, and
    `seq_fields` entries as raw (T, env-slice) sequences.

    Yields dicts {name: tensor} + key "masks"."""
    T, N = dones.shape[:2]
    dones = dones.reshape(T, N)
    mb = N // num_mini_batches
    for i in range(num_mini_batches):
        sl = slice(i * mb, (i + 1) * mb)
        d = dones[:, sl]
        out = {}
        masks = None
        for name, x in traj_fields.items():
            padded, masks = split_and_pad_trajectories(
                x[:, sl], d, max_num_trajs=max_num_trajs)
            out[name] = padded
        for name, x in seq_fields.items():
            out[name] = x[:, sl]
        out["masks"] = masks
        yield out
