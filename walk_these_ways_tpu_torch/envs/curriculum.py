"""On-device command curriculum.

Counterpart of the JAX package's envs/curriculum.py, itself a reformulation
of the reference's CPU/NumPy ``RewardThresholdCurriculum`` (reference:
go1_gym/envs/base/curriculum.py:17-154) that keeps everything on the device:

- the 15-D command grid is dense and static: ``grid`` (B, 15) bin centroids,
  one weight row per gait category (pronk/trot/pace/bound), built exactly like
  ``Curriculum.__init__`` (linspace of centroids, curriculum.py:28-55);
- the neighborhood expansion of ``update`` (curriculum.py:123-154) is a
  static boolean adjacency matrix: bins are adjacent iff |centroid_d(i) -
  centroid_d(j)| <= local_range_d for every dimension d — precomputed once in
  numpy, applied as a product;
- sampling is a Gumbel-top-1 categorical over weights + uniform jitter within
  the chosen cell (matches ``sample_bins``/``sample_uniform_from_cell``,
  curriculum.py:67-89, in distribution).

Weight-update semantics preserved from curriculum.py:135-154: a successful
env bumps its own bin by +0.2 once and every adjacent bin by +0.2 per
successful env, all clipped to [0, 1].

Random draws take an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..config import CommandsCfg

# local_range used by the reference at the single update call site
# (legged_robot.py:737-739)
LOCAL_RANGE = np.array(
    [0.55, 0.55, 0.55, 0.55, 0.35, 0.25, 0.25, 0.25, 0.25, 1.0, 1.0, 1.0, 1.0,
     1.0, 1.0]
)

CATEGORY_NAMES = ("pronk", "trot", "pace", "bound")

# curriculum task-reward keys (legged_robot.py:728-729)
TASK_KEYS = (
    "tracking_lin_vel",
    "tracking_ang_vel",
    "tracking_contacts_shaped_force",
    "tracking_contacts_shaped_vel",
)


class CurriculumGrid(NamedTuple):
    """Static (numpy) curriculum geometry."""

    grid: np.ndarray        # (B, 15) bin centroids
    bin_sizes: np.ndarray   # (15,)
    adjacency: np.ndarray   # (B, B) float32 neighbor mask (includes self)
    num_bins: int


class CurriculumState(NamedTuple):
    weights: torch.Tensor        # (C, B) in [0, 1]
    # per-bin diagnostics, monotonic accumulators
    bin_task_sums: torch.Tensor  # (C, B, len(TASK_KEYS)) summed ep means
    bin_ep_counts: torch.Tensor  # (C, B) episodes scored per bin


def make_grid(cfg: CommandsCfg) -> CurriculumGrid:
    counts = cfg.bin_counts
    lows = np.array(cfg.limits_low)
    highs = np.array(cfg.limits_high)
    axes = []
    bin_sizes = (highs - lows) / np.array(counts)
    for lo, hi, n, bs in zip(lows, highs, counts, bin_sizes):
        axes.append(np.linspace(lo + bs / 2, hi - bs / 2, n))
    mesh = np.meshgrid(*axes, indexing="ij")
    grid = np.stack([m.reshape(-1) for m in mesh], axis=-1)  # (B, 15)
    diff = np.abs(grid[:, None, :] - grid[None, :, :])       # (B, B, 15)
    adjacency = (diff <= LOCAL_RANGE[None, None, :]).all(axis=-1)
    return CurriculumGrid(
        grid=grid.astype(np.float32),
        bin_sizes=bin_sizes.astype(np.float32),
        adjacency=adjacency.astype(np.float32),
        num_bins=grid.shape[0],
    )


def init_state(cfg: CommandsCfg, grid: CurriculumGrid,
               num_categories: int = 4, device="cuda") -> CurriculumState:
    """Weights = 1 on bins inside the initial command ranges
    (``Curriculum.set_to``, curriculum.py:18-26)."""
    lo = np.array(cfg.ranges_low)
    hi = np.array(cfg.ranges_high)
    inside = ((grid.grid >= lo[None, :]) & (grid.grid <= hi[None, :])).all(axis=-1)
    w = np.tile(inside.astype(np.float32)[None, :], (num_categories, 1))
    B = grid.num_bins
    return CurriculumState(
        weights=torch.tensor(w, device=device),
        bin_task_sums=torch.zeros((num_categories, B, len(TASK_KEYS)),
                                  device=device),
        bin_ep_counts=torch.zeros((num_categories, B), device=device),
    )


def _const(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(arr, dtype=torch.float32, device=like.device)


def update(
    state: CurriculumState,
    grid: CurriculumGrid,
    update_mask: torch.Tensor,      # (N,) envs whose episodes are being scored
    env_bins: torch.Tensor,         # (N,) int
    env_categories: torch.Tensor,   # (N,) int
    task_reward_means: torch.Tensor,  # (N, len(TASK_KEYS)) command_sums / ep_len
    success_thresholds: torch.Tensor,  # (len(TASK_KEYS),) threshold * dt-scale
    adjacency: "torch.Tensor | None" = None,
) -> CurriculumState:
    """Vectorized RewardThresholdCurriculum.update (curriculum.py:135-154).
    `adjacency` is the grid's neighbor mask already on the device (made
    from `grid.adjacency` when not given)."""
    C, B = state.weights.shape
    K = task_reward_means.shape[-1]
    success = torch.all(task_reward_means > success_thresholds[None, :],
                        dim=-1)
    success = success & update_mask                        # (N,)
    # all per-bin accumulations in one scatter-add over the flat bin index
    flat_idx = (env_categories * B + env_bins).long()
    um = update_mask.to(torch.float32)
    rhs = torch.cat(
        [success.to(torch.float32)[:, None],
         task_reward_means * um[:, None],
         um[:, None]], dim=1)                              # (N, K+2)
    acc = torch.zeros((C * B, K + 2), dtype=torch.float32,
                      device=rhs.device).index_add_(0, flat_idx, rhs)
    counts = acc[:, 0].reshape(C, B)
    direct = (counts > 0).to(torch.float32)                # +0.2 once per bin
    if adjacency is None:
        adjacency = _const(grid.adjacency, counts)
    adj = counts @ adjacency                               # +0.2 per successful env
    new_w = torch.clamp(state.weights + 0.2 * direct + 0.2 * adj, 0.0, 1.0)
    # per-bin diagnostics: every scored episode contributes its task-reward
    # means and a count to its bin
    task_sums = state.bin_task_sums + acc[:, 1:1 + K].reshape(C, B, K)
    ep_counts = state.bin_ep_counts + acc[:, 1 + K].reshape(C, B)
    return CurriculumState(weights=new_w, bin_task_sums=task_sums,
                           bin_ep_counts=ep_counts)


def _gumbel(shape, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _keep(x, keep):
    """`keep(x)`, the rows kept of a draw, or all of them."""
    return x if keep is None else keep(x)


def sample(
    state: CurriculumState,
    grid: CurriculumGrid,
    generator: torch.Generator,
    n: int,
    keep=None,
    centroids: "torch.Tensor | None" = None,
    bin_sizes: "torch.Tensor | None" = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample (commands, bins, categories) for n envs.

    Category ~ uniform over 4 (legged_robot.py:742-746); bin ~ categorical
    over that category's weights (Gumbel-argmax over the weight row);
    command ~ uniform within the bin cell.  With `keep` (a function of the
    rows of a draw) the draws are made for all n envs and the rows it keeps
    returned: a rank of a data-parallel run draws what the whole batch
    draws (parallel/mesh.EnvRows).  `centroids` and `bin_sizes` are the
    grid's `grid` and `bin_sizes` already on the device (made from `grid`
    when not given)."""
    dev = state.weights.device
    C, B = state.weights.shape
    cats = _keep(torch.randint(0, C, (n,), generator=generator, device=dev),
                 keep)
    logw = torch.log(torch.clamp(state.weights, min=1e-12))   # (C, B)
    g = _keep(_gumbel((n, B), generator, dev), keep)
    bins = torch.argmax(logw[cats] + g, dim=-1)            # (n,)
    if centroids is None:
        centroids = _const(grid.grid, state.weights)
    if bin_sizes is None:
        bin_sizes = _const(grid.bin_sizes, state.weights)
    jitter = _keep(torch.rand((n, grid.grid.shape[1]), generator=generator,
                              device=dev), keep) - 0.5
    cmds = centroids[bins] + jitter * bin_sizes[None, :]   # (n, 15)
    return cmds, bins.to(torch.int32), cats.to(torch.int32)


# -- generic curriculum grids (reference Curriculum / SumCurriculum) --------

class GenericGrid(NamedTuple):
    """Static geometry of a generic binned curriculum built from
    ``key=(low, high, num_bins)`` ranges — the reference's base
    ``Curriculum.__init__`` (curriculum.py:28-55), minus the host RNG."""

    grid: np.ndarray       # (B, K) bin centroids
    bin_sizes: np.ndarray  # (K,)
    counts: Tuple[int, ...]
    keys: Tuple[str, ...]


def make_generic_grid(**key_ranges) -> GenericGrid:
    axes, sizes, counts = [], [], []
    for lo, hi, n in key_ranges.values():
        bs = (hi - lo) / n
        axes.append(np.linspace(lo + bs / 2, hi - bs / 2, n))
        sizes.append(bs)
        counts.append(n)
    mesh = np.meshgrid(*axes, indexing="ij")
    grid = np.stack([m.reshape(-1) for m in mesh], axis=-1)
    return GenericGrid(grid=grid.astype(np.float32),
                       bin_sizes=np.array(sizes, np.float32),
                       counts=tuple(counts),
                       keys=tuple(key_ranges.keys()))


def sample_generic(weights: torch.Tensor, grid: GenericGrid,
                   generator: torch.Generator,
                   n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted bin choice + uniform jitter within the cell — the base
    ``Curriculum.sample`` (curriculum.py:67-89).  Returns (values, bins)."""
    dev = weights.device
    logw = torch.log(torch.clamp(weights, min=1e-12))
    g = _gumbel((n, weights.shape[0]), generator, dev)
    bins = torch.argmax(logw[None, :] + g, dim=-1)
    centroids = _const(grid.grid, weights)[bins]
    jitter = torch.rand((n, grid.grid.shape[1]), generator=generator,
                        device=dev) - 0.5
    return centroids + jitter * _const(grid.bin_sizes, weights)[None, :], \
        bins.to(torch.int32)


class SumCurriculumState(NamedTuple):
    """Success/trial accumulators per bin — the reference
    ``SumCurriculum`` (curriculum.py:90-111) without the host round trip."""

    success: torch.Tensor  # (B,)
    trials: torch.Tensor   # (B,)


def sum_init(grid: GenericGrid, device="cuda") -> SumCurriculumState:
    B = grid.grid.shape[0]
    return SumCurriculumState(success=torch.zeros(B, device=device),
                              trials=torch.zeros(B, device=device))


def sum_update(state: SumCurriculumState, bin_inds: torch.Tensor,
               l1_error: torch.Tensor,
               threshold: float) -> SumCurriculumState:
    """curriculum.py:97-101: a trial per scored env, a success where the
    error beats the threshold (scatter-add collapses duplicate bins)."""
    ok = (l1_error < threshold).to(torch.float32)
    idx = bin_inds.long()
    return SumCurriculumState(
        success=state.success.index_add(0, idx, ok),
        trials=state.trials.index_add(0, idx, torch.ones_like(ok)))


def success_rates(state: SumCurriculumState, grid: GenericGrid,
                  *keys: str) -> torch.Tensor:
    """Success rate marginalized onto the named keys
    (curriculum.py:103-110): mean over every other grid dimension."""
    rate = (state.success / (state.trials + 1e-6)).reshape(grid.counts)
    marginals = tuple(i for i, k in enumerate(grid.keys) if k not in keys)
    if marginals:
        rate = rate.mean(dim=marginals)
    return rate


def postprocess_gaitwise(cmds: torch.Tensor, cats: torch.Tensor,
                         cfg: CommandsCfg) -> torch.Tensor:
    """Per-gait phase/offset/bound mapping (legged_robot.py:763-820)."""
    c5, c6, c7 = cmds[:, 5], cmds[:, 6], cmds[:, 7]
    zero = torch.zeros_like(c5)
    if cfg.gaitwise_curricula:
        pronk = cats == 0
        trot = cats == 1
        pace = cats == 2
        bound = cats == 3
        c5 = torch.where(pronk, torch.remainder(c5 / 2 - 0.25, 1), c5)
        c6 = torch.where(pronk, torch.remainder(c6 / 2 - 0.25, 1), c6)
        c7 = torch.where(pronk, torch.remainder(c7 / 2 - 0.25, 1), c7)
        c5 = torch.where(trot, cmds[:, 5] / 2 + 0.25, c5)
        c6 = torch.where(trot, zero, c6)
        c7 = torch.where(trot, zero, c7)
        c5 = torch.where(pace, zero, c5)
        c6 = torch.where(pace, cmds[:, 6] / 2 + 0.25, c6)
        c7 = torch.where(pace, zero, c7)
        c5 = torch.where(bound, zero, c5)
        c6 = torch.where(bound, zero, c6)
        c7 = torch.where(bound, cmds[:, 7] / 2 + 0.25, c7)
    if cfg.binary_phases:
        # torch.round is round-half-to-even, like the reference
        c5 = torch.remainder(torch.round(2 * c5) / 2.0, 1)
        c6 = torch.remainder(torch.round(2 * c6) / 2.0, 1)
        c7 = torch.remainder(torch.round(2 * c7) / 2.0, 1)
    # zero out small planar velocity commands (legged_robot.py:820)
    small = torch.linalg.norm(cmds[:, :2], dim=-1) <= 0.2
    xy = cmds[:, :2] * torch.where(small, 0.0, 1.0)[:, None]
    return torch.cat([xy, cmds[:, 2:5], c5[:, None], c6[:, None],
                      c7[:, None], cmds[:, 8:]], dim=1)
