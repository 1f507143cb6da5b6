"""Reward terms and the command curriculum of the port vs the JAX package.

Every reward term (the active ones and those the MoB config leaves at scale
0) on one random context made with numpy; the curriculum's grid, its update
with scored episodes, the gait post-processing and the sum curriculum on the
same inputs.  Sampling draws from different random streams and is checked
by its ranges and bins.  Tolerance rtol 1e-5 / atol 1e-6 (float32, same
formulas).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu import go1_config as j_cfg
from walk_these_ways_tpu.envs import curriculum as j_curr
from walk_these_ways_tpu.envs import rewards as j_rew

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import curriculum as t_curr
from walk_these_ways_tpu_torch.envs import rewards as t_rew

from test_torch_util import assert_close, t

torch.set_num_threads(1)
N = 32
RTOL, ATOL = 1e-5, 1e-6


def _ctx_arrays():
    rs = np.random.RandomState(0)
    f = lambda *s: rs.randn(*s).astype(np.float32)      # noqa: E731
    quat = f(N, 4)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    cmds = f(N, 15)
    cmds[:, 4] = rs.uniform(2, 4, N)
    last_actions = f(N, 12)
    last_actions[::3] = 0.0                             # the != 0 masks
    lim = np.stack([-np.ones(12), np.ones(12)], -1).astype(np.float32)
    return dict(
        commands=cmds, base_pos=f(N, 3), base_quat=quat,
        base_lin_vel=f(N, 3), base_ang_vel=f(N, 3),
        projected_gravity=f(N, 3),
        gravity_vec=np.tile(np.array([[0, 0, -1.0]], np.float32), (N, 1)),
        dof_pos=2 * f(N, 12), default_dof_pos=f(12), dof_vel=f(N, 12),
        last_dof_vel=f(N, 12), torques=f(N, 12), actions=f(N, 12),
        last_actions=last_actions, last_last_actions=f(N, 12),
        joint_pos_target=f(N, 12), last_joint_pos_target=f(N, 12),
        last_last_joint_pos_target=f(N, 12),
        contact_forces=3 * f(N, 17, 3), foot_velocities=f(N, 4, 3),
        prev_foot_velocities=f(N, 4, 3),
        foot_positions=np.abs(0.05 * f(N, 4, 3)),
        desired_contact_states=rs.uniform(0, 1, (N, 4)).astype(np.float32),
        foot_indices=rs.uniform(0, 1, (N, 4)).astype(np.float32),
        last_contacts=rs.rand(N, 4) > 0.5, dof_pos_limits=lim)


@pytest.fixture(scope="module")
def ctxs():
    arrs = _ctx_arrays()
    static = dict(dt=0.02, feet_indices=(4, 8, 12, 16),
                  penalised_indices=(2, 3, 6, 7, 10, 11, 14, 15))
    cj = j_rew.RewardCtx(cfg=j_cfg.mob_train_cfg(N), **static,
                         **{k: jnp.asarray(v) for k, v in arrs.items()})
    ct = t_rew.RewardCtx(cfg=t_cfg.mob_train_cfg(N), **static,
                         **{k: t(v) for k, v in arrs.items()})
    return cj, ct


def test_term_tables_agree():
    assert list(t_rew.TERMS) == list(j_rew.TERMS)
    assert t_rew.active_terms(t_cfg.mob_train_cfg(4)) == \
        j_rew.active_terms(j_cfg.mob_train_cfg(4))


@pytest.mark.parametrize("name", list(j_rew.TERMS))
def test_reward_term_matches_jax(ctxs, name):
    cj, ct = ctxs
    out_j = j_rew.TERMS[name](cj)
    out_t = t_rew.TERMS[name](ct)
    assert tuple(out_t.shape) == (N,)
    assert_close(out_t, out_j, RTOL, 1e-5 if name in ("dof_acc", "torques")
                 else ATOL, err_msg=name)


def test_grid_and_initial_weights_match_jax():
    cfg_j, cfg_t = j_cfg.mob_train_cfg(4).commands, t_cfg.mob_train_cfg(4).commands
    gj, gt = j_curr.make_grid(cfg_j), t_curr.make_grid(cfg_t)
    assert gt.num_bins == gj.num_bins == 441
    for f in ("grid", "bin_sizes", "adjacency"):
        np.testing.assert_array_equal(getattr(gt, f), getattr(gj, f))
    sj = j_curr.init_state(cfg_j, gj)
    st = t_curr.init_state(cfg_t, gt, device="cpu")
    for f in st._fields:
        assert_close(getattr(st, f), getattr(sj, f), 0, 0, err_msg=f)


def test_curriculum_update_matches_jax():
    cfg_j, cfg_t = j_cfg.mob_train_cfg(4).commands, t_cfg.mob_train_cfg(4).commands
    gj, gt = j_curr.make_grid(cfg_j), t_curr.make_grid(cfg_t)
    sj = j_curr.init_state(cfg_j, gj)
    st = t_curr.init_state(cfg_t, gt, device="cpu")
    rs = np.random.RandomState(1)
    n = 200
    thr = np.array([0.5, 0.5, 0.5, 0.5], np.float32)
    for _ in range(2):
        mask = rs.rand(n) > 0.4
        bins = rs.randint(0, 441, n).astype(np.int32)
        bins[:20] = 220                                  # duplicates in a bin
        cats = rs.randint(0, 4, n).astype(np.int32)
        means = rs.uniform(0, 1, (n, 4)).astype(np.float32)
        means[:40] = 0.9                                 # successes
        sj = j_curr.update(sj, gj, jnp.asarray(mask), jnp.asarray(bins),
                           jnp.asarray(cats), jnp.asarray(means),
                           jnp.asarray(thr))
        st = t_curr.update(st, gt, t(mask), t(bins), t(cats), t(means), t(thr))
    assert float(np.asarray(sj.weights).sum()) > 4 * 9   # it grew
    for f in st._fields:
        assert_close(getattr(st, f), getattr(sj, f), RTOL, ATOL, err_msg=f)


def test_postprocess_gaitwise_matches_jax():
    cfg_j, cfg_t = j_cfg.mob_train_cfg(4).commands, t_cfg.mob_train_cfg(4).commands
    rs = np.random.RandomState(2)
    cmds = rs.uniform(-1, 1, (64, 15)).astype(np.float32)
    cmds[:, 5:8] = rs.uniform(0, 1, (64, 3))
    cmds[:8, :2] *= 0.05                                 # small planar commands
    cats = rs.randint(0, 4, 64).astype(np.int32)
    assert_close(t_curr.postprocess_gaitwise(t(cmds), t(cats), cfg_t),
                 j_curr.postprocess_gaitwise(jnp.asarray(cmds),
                                             jnp.asarray(cats), cfg_j),
                 RTOL, ATOL)


def test_sample_draws_inside_weighted_bins():
    cfg_t = t_cfg.mob_train_cfg(4).commands
    gt = t_curr.make_grid(cfg_t)
    st = t_curr.init_state(cfg_t, gt, device="cpu")
    g = torch.Generator().manual_seed(0)
    cmds, bins, cats = t_curr.sample(st, gt, g, 500)
    assert cmds.shape == (500, 15) and bins.dtype == torch.int32
    assert bool((st.weights[cats.long(), bins.long()] > 0).all())
    centroids = torch.from_numpy(gt.grid)[bins.long()]
    half = torch.from_numpy(gt.bin_sizes)[None] / 2
    assert bool(((cmds - centroids).abs() <= half + 1e-6).all())
    assert set(cats.tolist()) == {0, 1, 2, 3}
    # the generic form: same weighted choice on a small grid
    gg_t = t_curr.make_generic_grid(x=(0.0, 1.0, 4), y=(-1.0, 1.0, 2))
    gg_j = j_curr.make_generic_grid(x=(0.0, 1.0, 4), y=(-1.0, 1.0, 2))
    np.testing.assert_array_equal(gg_t.grid, gg_j.grid)
    w = torch.tensor([0, 0, 1.0, 0, 0, 0, 0, 1.0])
    vals, b = t_curr.sample_generic(w, gg_t, g, 200)
    assert set(b.tolist()) == {2, 7} and vals.shape == (200, 2)


def test_sum_curriculum_matches_jax():
    gg_t = t_curr.make_generic_grid(x=(0.0, 1.0, 4), y=(-1.0, 1.0, 2))
    gg_j = j_curr.make_generic_grid(x=(0.0, 1.0, 4), y=(-1.0, 1.0, 2))
    rs = np.random.RandomState(3)
    bins = rs.randint(0, 8, 50).astype(np.int32)
    err = rs.uniform(0, 1, 50).astype(np.float32)
    sj = j_curr.sum_update(j_curr.sum_init(gg_j), jnp.asarray(bins),
                           jnp.asarray(err), 0.5)
    st = t_curr.sum_update(t_curr.sum_init(gg_t, device="cpu"), t(bins),
                           t(err), 0.5)
    assert_close(st.success, sj.success, 0, 0)
    assert_close(st.trials, sj.trials, 0, 0)
    assert_close(t_curr.success_rates(st, gg_t, "x"),
                 j_curr.success_rates(sj, gg_j, "x"), RTOL, ATOL)
    assert_close(t_curr.success_rates(st, gg_t, "x", "y"),
                 j_curr.success_rates(sj, gg_j, "x", "y"), RTOL, ATOL)
