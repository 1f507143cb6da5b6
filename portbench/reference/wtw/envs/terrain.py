"""Frozen copy of walk_these_ways_tpu_torch/envs/terrain.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Procedural terrain generator (host-side, init-time numpy).

Counterpart of the reference Terrain class + isaacgym
terrain_utils tile library (reference: go1_gym/utils/terrain.py:12-179).
The heightfield is generated once in numpy at env construction and shipped
to the device as a single (rows, cols) float32 array — the reference
instead rebuilds a trimesh inside PhysX and samples min-of-3 neighbors on
device (legged_robot.py:1772-1806).

Tile semantics mirror terrain.py:114-159: per-tile type chosen by cumulative
proportions, difficulty by row (curriculum) or random choice of
{0.5, 0.75, 0.9}; tile types in order:
  0: pyramid slope (down if first half)   5: stepping stones
  1: rough pyramid slope                  6: flat (pass)
  2/3: pyramid stairs (down/up)           7: flat (pass)
  4: discrete obstacles                   8: random uniform rough
  9: half rough / half flat
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..config import TerrainCfg


@dataclasses.dataclass
class TerrainArrays:
    height: np.ndarray          # (rows_px, cols_px) float32 meters
    env_origins: np.ndarray     # (num_rows, num_cols, 3) tile origin centers
    horizontal_scale: float
    origin_xy: Tuple[float, float]


def _tile(cfg: TerrainCfg, rng: np.random.RandomState, choice: float,
          difficulty: float, size_px: Tuple[int, int]) -> np.ndarray:
    w, l = size_px
    hs = cfg.horizontal_scale
    hf = np.zeros((w, l), dtype=np.float32)
    props = np.cumsum(np.asarray(cfg.terrain_proportions, dtype=np.float64))
    props = np.concatenate([props, np.full(10 - len(props), props[-1] if len(props) else 0)])
    slope = difficulty * 0.4
    step_height = 0.05 + 0.18 * difficulty
    obstacle_height = 0.05 + difficulty * (cfg.max_platform_height - 0.05)
    stone_size = 1.5 * (1.05 - difficulty)
    stone_distance = 0.05 if difficulty == 0 else 0.1

    xs = (np.arange(w) - w / 2) * hs
    ys = (np.arange(l) - l / 2) * hs
    X, Y = np.meshgrid(xs, ys, indexing="ij")

    def pyramid_slope(s):
        d = np.maximum(np.abs(X), np.abs(Y))
        peak = s * (w * hs / 2)
        h = peak - s * d
        platform = 3.0 / 2
        h = np.where(np.maximum(np.abs(X), np.abs(Y)) < platform,
                     peak - s * platform, h)
        return (h - h.min() if s > 0 else h - h.max()).astype(np.float32)

    def rough(mag, step=0.005, down=0.2):
        if mag <= 0:
            return np.zeros_like(hf)
        cw = max(int(down / hs), 1)
        gw, gl = w // cw + 2, l // cw + 2
        vals = rng.uniform(-mag, mag, (gw, gl))
        vals = np.round(vals / step) * step
        gx = np.clip((np.arange(w) / cw), 0, gw - 2)
        gy = np.clip((np.arange(l) / cw), 0, gl - 2)
        i0, j0 = gx.astype(int), gy.astype(int)
        fx, fy = gx - i0, gy - j0
        out = (vals[np.ix_(i0, j0)] * (1 - fx)[:, None] * (1 - fy)[None, :]
               + vals[np.ix_(i0 + 1, j0)] * fx[:, None] * (1 - fy)[None, :]
               + vals[np.ix_(i0, j0 + 1)] * (1 - fx)[:, None] * fy[None, :]
               + vals[np.ix_(i0 + 1, j0 + 1)] * fx[:, None] * fy[None, :])
        return out.astype(np.float32)

    def pyramid_stairs(sh):
        step_w_px = max(int(0.31 / hs), 1)
        d_px = np.maximum(np.abs(X), np.abs(Y)) / hs
        ring = np.floor((np.maximum(w, l) / 2 - d_px) / step_w_px)
        platform_px = 3.0 / 2 / hs
        max_ring = np.floor((np.maximum(w, l) / 2 - platform_px) / step_w_px)
        ring = np.clip(ring, 0, max_ring)
        return (ring * sh).astype(np.float32)

    def discrete_obstacles():
        out = np.zeros_like(hf)
        for _ in range(20):
            ow = int(rng.uniform(1.0, 2.0) / hs)
            ol = int(rng.uniform(1.0, 2.0) / hs)
            ox = rng.randint(0, max(w - ow, 1))
            oy = rng.randint(0, max(l - ol, 1))
            out[ox:ox + ow, oy:oy + ol] = rng.choice(
                [-obstacle_height, -obstacle_height / 2,
                 obstacle_height / 2, obstacle_height])
        # central platform flat
        px = int(1.0 / hs)
        out[w // 2 - px:w // 2 + px, l // 2 - px:l // 2 + px] = 0.0
        return out

    def stepping_stones():
        out = np.full_like(hf, -1.0)
        s_px = max(int(stone_size / hs), 1)
        gap_px = max(int(stone_distance / hs), 1)
        pitch = s_px + gap_px
        for ix in range(0, w, pitch):
            for iy in range(0, l, pitch):
                out[ix:ix + s_px, iy:iy + s_px] = 0.0
        px = int(4.0 / 2 / hs)
        out[w // 2 - px:w // 2 + px, l // 2 - px:l // 2 + px] = 0.0
        return out

    if choice < props[0]:
        s = -slope if choice < props[0] / 2 else slope
        hf += pyramid_slope(s)
    elif choice < props[1]:
        hf += pyramid_slope(slope) + rough(0.05, cfg.terrain_smoothness)
    elif choice < props[3]:
        sh = -step_height if choice < props[2] else step_height
        hf += pyramid_stairs(sh)
    elif choice < props[4]:
        hf += discrete_obstacles()
    elif choice < props[5]:
        hf += stepping_stones()
    elif choice < props[6] or choice < props[7]:
        pass
    elif choice < props[8]:
        hf += rough(cfg.terrain_noise_magnitude, 0.005)
    elif choice < props[9]:
        hf += rough(0.05, cfg.terrain_smoothness)
        hf[: w // 2, :] = 0.0
    return hf


def build(cfg: TerrainCfg, seed: int = 0) -> TerrainArrays:
    rng = np.random.RandomState(seed)
    wpx = int(cfg.terrain_length / cfg.horizontal_scale)
    lpx = int(cfg.terrain_width / cfg.horizontal_scale)
    border = int(cfg.border_size / cfg.horizontal_scale)
    rows_px = cfg.num_rows * wpx + 2 * border
    cols_px = cfg.num_cols * lpx + 2 * border
    height = np.zeros((rows_px, cols_px), dtype=np.float32)
    origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))
    for i in range(cfg.num_rows):
        for j in range(cfg.num_cols):
            if cfg.curriculum:
                difficulty = i / cfg.num_rows * cfg.difficulty_scale
                choice = j / cfg.num_cols + 0.001
            else:
                choice = rng.uniform(0, 1)
                difficulty = rng.choice([0.5, 0.75, 0.9])
            tile = _tile(cfg, rng, choice, difficulty, (wpx, lpx))
            x0, y0 = border + i * wpx, border + j * lpx
            height[x0:x0 + wpx, y0:y0 + lpx] = tile
            origins[i, j] = [
                (i + 0.5) * cfg.terrain_length,
                (j + 0.5) * cfg.terrain_width,
                tile.max(),
            ]
    # quantize like the reference's int16 heightfield (vertical_scale units)
    height = np.round(height / cfg.vertical_scale) * cfg.vertical_scale
    return TerrainArrays(
        height=height,
        env_origins=origins,
        horizontal_scale=cfg.horizontal_scale,
        origin_xy=(-cfg.border_size, -cfg.border_size),
    )


def assign_env_origins(cfg: TerrainCfg, arrays: TerrainArrays, num_envs: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """Terrain level/type per env (reference legged_robot.py:1675-1714)."""
    if cfg.center_robots:
        min_lvl = max(cfg.num_rows // 2 - cfg.center_span, 0)
        max_lvl = min(cfg.num_rows // 2 + cfg.center_span - 1,
                      cfg.num_rows - 1)
        min_typ = max(cfg.num_cols // 2 - cfg.center_span, 0)
        max_typ = min(cfg.num_cols // 2 + cfg.center_span - 1,
                      cfg.num_cols - 1)
        levels = rng.randint(min_lvl, max_lvl + 1, num_envs)
        types = rng.randint(min_typ, max_typ + 1, num_envs)
    else:
        max_init = cfg.max_init_terrain_level if cfg.curriculum else cfg.num_rows - 1
        max_init = min(max_init, cfg.num_rows - 1)
        min_init = cfg.min_init_terrain_level if cfg.curriculum else 0
        min_init = min(min_init, max_init)
        levels = rng.randint(min_init, max_init + 1, num_envs)
        types = (np.arange(num_envs) // (num_envs / cfg.num_cols)).astype(int)
        types = np.clip(types, 0, cfg.num_cols - 1)
    return arrays.env_origins[levels, types].astype(np.float32)
