"""Walk-these-ways velocity-tracking environment on PyTorch.

Counterpart of the JAX package's envs/go1_env.py: the functional rebuild of
the reference env stack — BaseTask + LeggedRobot + VelocityTrackingEasyEnv +
HistoryWrapper (reference: go1_gym/envs/base/base_task.py,
go1_gym/envs/base/legged_robot.py,
go1_gym/envs/go1/velocity_tracking/__init__.py,
go1_gym/envs/wrappers/history_wrapper.py) — as a single step function over
an `EnvState` tuple of tensors:

    step: (EnvState, actions) -> (EnvState, obs_dict, rew, done, info)

Everything the reference does with ~60 mutable buffers and per-env-id
indexed resets is a masked dense update here.  `step` builds new tensors and
does not write into the state it was given; the only object it mutates is
the `torch.Generator` carried in `EnvState.rng`, which every random draw
advances.

Step ordering mirrors LeggedRobot.step/post_physics_step exactly
(legged_robot.py:60-136): clip actions -> decimation x {torque model,
physics} -> kinematic quantities -> teleport/resample/gait-clock/push/DR
callbacks -> termination -> rewards -> masked auto-reset -> observations ->
shift last_* buffers.

Physics runs on flat ground or a heightfield.  On the two env-minor kernel
routes (`sim.use_pallas_contact` on): with `sim.megastep` one launch of the
whole-control-step kernel per control step (ops/megastep.py), in reuse mode
or, with `sim.reuse_matrices` off, in exact mode (on flat ground the cache
rebuilt inside the kernel before every substep; on a heightfield
`decimation` reuse-mode launches of one substep each, every one from a
fresh cache and fresh terrain samples); with `sim.megastep` off one
contact-cache launch per control step (reuse) or per substep (exact) and
one dynamics-substep launch per physics substep (ops/contact.py,
ops/dynamics.py), the torque model evaluated between them
(`_compute_torques`).  With `sim.use_pallas_contact` off (the `SimCfg`
default, and `go1_cfg()`'s physics), the dense route of physics/engine.py
in stock torch ops: per substep the torque model, then
`physics_substep_cached` on a cache built once per control step (reuse
mode) or `physics_substep` (exact mode).

Train/eval env split (reference base_task.py:43-50): with `eval_cfg`, its
`env.num_envs` eval envs are appended after the train envs.  The two slices
may differ in `domain_rand` (per-env ranges), `commands` (a curriculum of
their own) and `terrain` (the eval rows appended to the train heightfield);
physics sees one batch of T + E envs on every route.

Env-axis data parallelism (parallel/mesh.py): with `mesh`, the env holds
its rank's rows of the global batch (`rows`, an `EnvRows`: T / W train
rows, then E / W eval rows) and steps them through its own kernel
launches.  Every random draw takes the global batch's shape from the
state's generator, which is the same on every rank, and keeps the rank's
rows; the curriculum update gathers every env's scores first and the
reward terms' signs come from their sums over every env.  So W ranks
compute what one rank computes.  `StepInfo`'s episode sums are the rank's
own (the learner sums them over the ranks once an iteration).  With a mesh
of one rank nothing changes, bit for bit.

CUDA graph: on a CUDA device, with one rank and a control-step kernel route
(`sim.use_pallas_contact` and `sim.megastep`), `step` runs its first call
eagerly, captures the step once on its second call and from then on
replays that graph: a thousand small device ops become one graph launch
per control step, with the same kernels in the same order, so the outputs
and the generator's state are bit for bit the eager step's (but for the
curriculum's per-bin task sums, which the card's `index_add` sums in the
order its atomics land, eager step or not).  Every other
env (the CPU, a distributed mesh, whose gathers are collectives, the
per-substep and dense routes) steps eagerly.  The module counters
`graph_captures`, `graph_replays` and `eager_steps` count what `step` did.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..config import Cfg
from ..models import actuator_net
from ..models.robot import RobotModel, default_dof_pos, go1, pd_gains
from ..ops import megastep as megastep_ops
from ..ops import quat as qops
from ..parallel import mesh as mesh_mod
from ..physics import engine
from . import curriculum as curr
from . import rewards as rew_mod
from . import terrain as terrain_mod

COMMAND_SUM_KEYS = curr.TASK_KEYS + (
    "lin_vel_raw", "ang_vel_raw", "lin_vel_residual", "ang_vel_residual",
    "ep_timesteps",
)


# what `LeggedRobotEnv.step` did, over every env of the process: CUDA
# graphs captured, steps replayed from one, steps run eagerly
graph_captures = 0
graph_replays = 0
eager_steps = 0

# ops/megastep's launch counters, which a captured step moves: the capture
# counts nothing, and every replay adds what the captured step added
_LAUNCH_COUNTERS = ("launches", "p_launches", "normal_launches",
                    "p_normal_launches", "exact_launches", "p_exact_launches")


def _signature(leaves):
    """What a graph's static input must match in each leaf: a tensor's
    shape, dtype and device, else the leaf's type."""
    return tuple((x.shape, x.dtype, x.device) if isinstance(x, torch.Tensor)
                 else type(x) for x in leaves)


def _dense(x: torch.Tensor) -> bool:
    """Whether `x` covers its storage without gaps or overlaps: then
    `empty_like` gives its strides, and a tensor of its strides is a flat
    copy of it."""
    return torch.empty_like(x).stride() == x.stride()


def _copy(dsts, srcs, dense):
    """dst.copy_(src) for each pair (`dense` says which dsts are dense):
    pairs of dense tensors of the same strides through one multi-tensor
    copy per dtype, the rest one by one."""
    groups = {}
    for d, s, flat in zip(dsts, srcs, dense):
        if d.numel() == 0:
            continue
        if flat and d.stride() == s.stride() and d.dtype == s.dtype and \
                d.device == s.device:
            ds, ss = groups.setdefault(d.dtype, ([], []))
            ds.append(d)
            ss.append(s)
        else:
            d.copy_(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


class _StepGraph:
    """One CUDA graph of `LeggedRobotEnv._step`, captured from the call it
    is built on, with static copies of that call's state and actions as
    its inputs and the generator of its own that it draws from.

    `replay(state, actions)` copies the caller's tensors into the static
    inputs and the caller's generator state into the graph's generator,
    replays, hands the advanced generator state back, and returns copies
    of the static outputs that the caller owns (nothing it returns aliases
    the graph's buffers); an output the step passed through from its input
    is the caller's own tensor, as in the eager step.  A call whose
    structure, shapes, dtypes or devices differ from the captured one's
    gets None."""

    def __init__(self, env: "LeggedRobotEnv", state, actions):
        global graph_captures
        leaves, self.structure = pytree.tree_flatten((state, actions))
        self.signature = _signature(leaves)
        gens = [i for i, x in enumerate(leaves)
                if isinstance(x, torch.Generator)]
        if len(gens) != 1:
            raise ValueError("a step's state carries one generator")
        self.gen_index = gens[0]
        self.gen = torch.Generator(device=env.device)
        self.tensors = [i for i, x in enumerate(leaves)
                        if isinstance(x, torch.Tensor)]
        self.inputs = list(leaves)
        for i in self.tensors:
            self.inputs[i] = torch.empty_like(leaves[i])
        self.inputs[self.gen_index] = self.gen
        self.static_ins = [self.inputs[i] for i in self.tensors]
        self.in_dense = [_dense(x) for x in self.static_ins]
        _copy(self.static_ins, [leaves[i] for i in self.tensors],
              self.in_dense)
        self.gen.set_state(leaves[self.gen_index].get_state())
        # the device tensors the kernels read whose owner may drop them:
        # the graph holds their addresses, so it holds them too
        self.keep = env._graph_operands()
        counts = [getattr(megastep_ops, n) for n in _LAUNCH_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.gen)
        static_state, static_actions = pytree.tree_unflatten(
            self.inputs, self.structure)
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            out = env._step(static_state, static_actions)
        self.launches = []
        for n, before in zip(_LAUNCH_COUNTERS, counts):
            self.launches.append((n, getattr(megastep_ops, n) - before))
            setattr(megastep_ops, n, before)
        graph_captures += 1
        outs, self.out_structure = pytree.tree_flatten(out)
        # each output leaf: ("in", i) the caller's leaf i, which the step
        # passed through; ("new", j) the j-th copy made on every replay
        by_id = {id(x): i for i, x in enumerate(self.inputs)}
        self.static_outs, self.out_plan, made = [], [], {}
        for x in outs:
            if id(x) in by_id:
                self.out_plan.append(("in", by_id[id(x)]))
            elif isinstance(x, torch.Tensor):
                if id(x) not in made:
                    made[id(x)] = len(self.static_outs)
                    self.static_outs.append(x)
                self.out_plan.append(("new", made[id(x)]))
            else:
                raise TypeError(f"a step output of type {type(x)}")
        # `empty_like` keeps a dense output's strides
        self.out_dense = [_dense(x) for x in self.static_outs]

    def replay(self, state, actions):
        global graph_replays
        leaves, structure = pytree.tree_flatten((state, actions))
        if structure != self.structure or \
                _signature(leaves) != self.signature:
            return None
        _copy(self.static_ins, [leaves[i] for i in self.tensors],
              self.in_dense)
        rng = leaves[self.gen_index]
        self.gen.set_state(rng.get_state())
        self.graph.replay()
        rng.set_state(self.gen.get_state())
        fresh = [torch.empty_like(x) for x in self.static_outs]
        _copy(fresh, self.static_outs, self.out_dense)
        for n, d in self.launches:
            setattr(megastep_ops, n, getattr(megastep_ops, n) + d)
        graph_replays += 1
        return pytree.tree_unflatten(
            [leaves[i] if kind == "in" else fresh[i]
             for kind, i in self.out_plan], self.out_structure)


class EnvState(NamedTuple):
    phys: engine.PhysicsState
    rng: torch.Generator                 # advanced in place by every draw
    # control pipeline
    actions: torch.Tensor                # (N, 12) clipped policy actions
    last_actions: torch.Tensor
    last_last_actions: torch.Tensor
    joint_pos_target: torch.Tensor
    last_joint_pos_target: torch.Tensor
    last_last_joint_pos_target: torch.Tensor
    last_dof_vel: torch.Tensor
    lag_buffer: torch.Tensor             # (N, lag+1, 12)
    torques: torch.Tensor                # (N, 12) last applied
    # actuator-net history (updated per physics substep)
    joint_pos_err_last: torch.Tensor
    joint_pos_err_last_last: torch.Tensor
    joint_vel_last: torch.Tensor
    joint_vel_last_last: torch.Tensor
    # episode bookkeeping
    episode_length: torch.Tensor         # (N,) int32
    common_step: torch.Tensor            # () int32
    # commands & gait machinery
    commands: torch.Tensor               # (N, 15)
    gait_indices: torch.Tensor           # (N,)
    clock_inputs: torch.Tensor           # (N, 4)
    desired_contact_states: torch.Tensor  # (N, 4)
    foot_indices: torch.Tensor           # (N, 4)
    # kinematic caches from last substep
    contact_forces: torch.Tensor         # (N, 17, 3)
    foot_positions: torch.Tensor         # (N, 4, 3)
    foot_velocities: torch.Tensor        # (N, 4, 3)
    prev_foot_velocities: torch.Tensor
    last_contacts: torch.Tensor          # (N, 4) bool
    # domain randomization
    payloads: torch.Tensor               # (N,)
    com_displacements: torch.Tensor      # (N, 3)
    friction_coeffs: torch.Tensor        # (N,)
    restitutions: torch.Tensor           # (N,)
    motor_strengths: torch.Tensor        # (N, 12)
    motor_offsets: torch.Tensor          # (N, 12)
    Kp_factors: torch.Tensor             # (N, 12)
    Kd_factors: torch.Tensor             # (N, 12)
    gravity_offset: torch.Tensor         # (3,)  shared across envs
    # logging accumulators
    episode_sums: torch.Tensor           # (N, n_terms + 1) [+1 = total]
    command_sums: torch.Tensor           # (N, len(COMMAND_SUM_KEYS))
    # curriculum
    curriculum: curr.CurriculumState
    env_command_bins: torch.Tensor       # (N,) int32
    env_command_categories: torch.Tensor  # (N,) int32
    # observation history (HistoryWrapper state)
    obs_history: torch.Tensor            # (N, H * num_obs)
    # contact impulses carried across control steps for the cross-step
    # warm start (env-minor (P, 3, Npad) like the kernel carries them;
    # zeroed for reset envs)
    contact_lam_t: torch.Tensor          # (P, 3, Npad)
    # the eval slice's own command curriculum over eval_cfg.commands' grid
    # (None unless the eval commands cfg differs from the train one)
    curriculum_eval: "curr.CurriculumState | None" = None


class StepInfo(NamedTuple):
    time_outs: torch.Tensor               # (N,)
    env_bins: torch.Tensor                # (N,)
    # per-term sums over envs that finished an episode this step + count,
    # for host-side logging without a device->host sync in the hot loop
    ep_sums_done: torch.Tensor            # (n_terms + 1,)  train slice
    ep_count_done: torch.Tensor           # ()
    ep_len_done: torch.Tensor             # () summed episode lengths at done
    eval_ep_sums_done: torch.Tensor       # (n_terms + 1,)  eval slice
    eval_ep_count_done: torch.Tensor      # ()
    eval_ep_len_done: torch.Tensor        # ()
    torques: torch.Tensor                 # (N, 12)
    # envs terminated THIS step by the integrator-envelope crash guard
    envelope_exits: torch.Tensor          # ()


def make_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


class LeggedRobotEnv:
    """Static env context on one device (`device` defaults to "cuda", or
    with `mesh` to the mesh's device).

    Train/eval env split: with `eval_cfg`, `eval_cfg.env.num_envs` eval envs
    follow the `cfg.env.num_envs` train envs.  `eval_cfg` may differ from
    `cfg` only in `domain_rand`, `commands`, `terrain` and `env.num_envs`;
    the trainer runs the deterministic student (or teacher) on the eval
    slice and leaves it out of PPO (reference ppo_cse/__init__.py:140-147).

    With an env `mesh` (parallel/mesh.make_mesh) the counts `num_envs`,
    `num_train_envs` and `num_eval_envs` are the rank's, `rows` maps them
    to the global batch (`num_envs_global`), and each slice's count must
    divide over the ranks."""

    def __init__(self, cfg: Cfg, model: RobotModel | None = None,
                 terrain_seed: int = 0, eval_cfg: Cfg | None = None,
                 device=None, mesh: "mesh_mod.EnvMesh | None" = None):
        if device is None:
            device = mesh.device if mesh is not None else "cuda"
        self.device = torch.device(device)
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the env is on {self.device}, its mesh on "
                             f"{mesh.device}")
        self.mesh = mesh
        if self.device.type == "cuda":
            # float32 throughout: products must not drop to TF32
            if torch.backends.cuda.matmul.allow_tf32 is not False:
                raise RuntimeError(
                    "torch.backends.cuda.matmul.allow_tf32 must be False: "
                    "the port computes in full float32")
        dev = self.device
        self.cfg = cfg
        self.eval_cfg = eval_cfg
        self.model = model or go1()
        m = self.model
        self.rows = mesh_mod.env_rows(
            mesh, cfg.env.num_envs, eval_cfg.env.num_envs if eval_cfg else 0)
        self.num_train_envs = self.rows.t
        self.num_eval_envs = self.rows.e
        self.num_envs_global = self.rows.num_envs
        if eval_cfg is not None:
            # the reference's per-split cfg dispatch (_call_train_eval,
            # legged_robot.py:531-544) covers these sections; the rest of
            # the config is one for both slices
            def rest(c):
                return dataclasses.replace(
                    c, env=dataclasses.replace(c.env, num_envs=0),
                    domain_rand=cfg.domain_rand, commands=cfg.commands,
                    terrain=cfg.terrain)
            if rest(cfg) != rest(eval_cfg):
                raise ValueError("eval_cfg may differ from cfg only in "
                                 "domain_rand, commands, terrain and "
                                 "env.num_envs")
            cfg = dataclasses.replace(cfg, env=dataclasses.replace(
                cfg.env, num_envs=self.num_envs_global))
            self.cfg = cfg
        self.eval_commands_differ = (
            eval_cfg is not None and eval_cfg.commands != cfg.commands)
        self.eval_terrain_differs = (
            eval_cfg is not None and eval_cfg.terrain != cfg.terrain)
        self.num_envs = self.rows.n
        self.num_obs = cfg.env.num_observations
        self.num_privileged_obs = cfg.env.num_privileged_obs
        self.num_actions = cfg.env.num_actions
        self.num_obs_history = cfg.env.num_observation_history * self.num_obs
        self.dt = cfg.dt
        self.max_episode_length = cfg.max_episode_length
        self.reuse_matrices = cfg.sim.reuse_matrices

        # terrain ---------------------------------------------------------
        np_rng = np.random.RandomState(terrain_seed)
        hf_types = ("heightfield", "trimesh")
        if self.eval_terrain_differs and (
                cfg.terrain.mesh_type in hf_types
                or eval_cfg.terrain.mesh_type in hf_types):
            # per-split terrains: the eval rows appended after the train
            # rows in one heightfield (reference utils/terrain.py:12-30);
            # the eval envs' origins land on the eval rows
            combined, ev_shifted = terrain_mod.combine_with_eval(
                terrain_mod.build(cfg.terrain, seed=terrain_seed),
                terrain_mod.build(eval_cfg.terrain, seed=terrain_seed + 1))
            origins = np.concatenate([
                terrain_mod.assign_env_origins(
                    cfg.terrain, combined, self.rows.num_train, np_rng),
                terrain_mod.assign_env_origins(
                    eval_cfg.terrain, ev_shifted, self.rows.num_eval,
                    np_rng)], axis=0)
            self.terrain = self._field(combined, dev)
        elif cfg.terrain.mesh_type in hf_types:
            arrays = terrain_mod.build(cfg.terrain, seed=terrain_seed)
            self.terrain = self._field(arrays, dev)
            origins = terrain_mod.assign_env_origins(
                cfg.terrain, arrays, self.num_envs_global, np_rng)
        else:
            self.terrain = engine.flat_terrain(dev)
            origins = terrain_mod.grid_env_origins(self.num_envs_global)
        # the global batch's origins, then the rank's rows
        self.env_origins = torch.tensor(
            self.rows.take(np.asarray(origins)), dtype=torch.float32,
            device=dev)
        self.rough = tuple(self.terrain.height.shape) != (2, 2)

        self.sim_params = engine.SimParams(
            dt=cfg.sim.dt, num_contact_iters=cfg.sim.num_contact_iters,
            use_pallas_contact=cfg.sim.use_pallas_contact,
            contact_warm_start=cfg.sim.contact_warm_start,
            num_contact_iters_warm=cfg.sim.num_contact_iters_warm,
            contact_cross_step_warm_start=(
                cfg.sim.contact_cross_step_warm_start))

        # constants -------------------------------------------------------
        def f32(x):
            return torch.tensor(np.asarray(x), dtype=torch.float32,
                                device=dev)

        self.default_dof_pos = default_dof_pos(
            m, dict(cfg.init_state.default_joint_angles), device=dev)
        self.p_gains, self.d_gains = pd_gains(
            m, dict(cfg.control.stiffness), dict(cfg.control.damping),
            device=dev)
        self.torque_limits = f32(m.dof_effort)
        # soft dof position limits (legged_robot.py:603-607)
        lo = np.asarray(m.dof_lower)
        hi = np.asarray(m.dof_upper)
        mid, r = (lo + hi) / 2, hi - lo
        soft = cfg.rewards.soft_dof_pos_limit
        self.dof_pos_limits = f32(
            np.stack([mid - 0.5 * r * soft, mid + 0.5 * r * soft], axis=-1))
        self.feet_indices = tuple(int(i) for i in m.feet_report_indices)
        pen = []
        for i, name in enumerate(m.report_body_names):
            if "thigh" in name or "calf" in name:
                pen.append(i)
        self.penalised_indices = tuple(pen)
        self.termination_indices = (0,)  # base
        # the same as index tensors, and the other constants the step reads:
        # a tensor made from host data inside the step is a copy from
        # pageable memory every step, which a CUDA graph cannot capture
        def idx(x):
            return torch.tensor(x, dtype=torch.long, device=dev)
        self._feet_idx = idx(self.feet_indices)
        self._penalised_idx = idx(self.penalised_indices)
        self._termination_idx = idx(self.termination_indices)
        self._init_pos = f32(cfg.init_state.pos)
        self._init_rot = f32(cfg.init_state.rot)
        self._init_span = f32([cfg.terrain.x_init_range,
                               cfg.terrain.y_init_range])
        self._init_offset = f32([cfg.terrain.x_init_offset,
                                 cfg.terrain.y_init_offset])
        self._x_axis = f32([1.0, 0.0, 0.0])
        self._z_axis = f32([0.0, 0.0, 1.0])

        # commands scale (legged_robot.py:1196-1203)
        osc = cfg.obs_scales
        self.commands_scale = f32(
            [osc.lin_vel, osc.lin_vel, osc.ang_vel, osc.body_height_cmd,
             osc.gait_freq_cmd, osc.gait_phase_cmd, osc.gait_phase_cmd,
             osc.gait_phase_cmd, osc.gait_phase_cmd, osc.footswing_height_cmd,
             osc.body_pitch_cmd, osc.body_roll_cmd, osc.stance_width_cmd,
             osc.stance_length_cmd, osc.aux_reward_cmd][:cfg.commands.num_commands])

        self.noise_scale_vec = self._make_noise_vec()
        hip = np.array([1.0, 1.0, 1.0] * 4)
        hip[0::3] = cfg.control.hip_scale_reduction
        self._hip_scale = f32(hip)
        self._gravity_base = f32([0.0, 0.0, -9.8])

        # curriculum ------------------------------------------------------
        # each grid's adjacency, centroids and bin sizes on the device
        def on_device(grid):
            return (f32(grid.adjacency), f32(grid.grid), f32(grid.bin_sizes))
        self.curr_grid = curr.make_grid(cfg.commands)
        self._curr_consts = on_device(self.curr_grid)
        # per-split command curriculum: the eval slice samples from its own
        # grid over eval_cfg.commands (reference _call_train_eval,
        # legged_robot.py:531-544, 710-824)
        self.curr_grid_eval = self._curr_consts_eval = None
        if self.eval_commands_differ:
            self.curr_grid_eval = curr.make_grid(eval_cfg.commands)
            self._curr_consts_eval = on_device(self.curr_grid_eval)
        # dt-scaled reward scales (legged_robot.py:1394-1400)
        self.reward_names = rew_mod.active_terms(cfg)
        scales = dict(cfg.reward_scales.items())
        self.reward_scales = tuple(scales[n] * self.dt for n in self.reward_names)
        thr = cfg.curriculum_thresholds
        thr_map = dict(
            tracking_lin_vel=thr.tracking_lin_vel,
            tracking_ang_vel=thr.tracking_ang_vel,
            tracking_contacts_shaped_force=thr.tracking_contacts_shaped_force,
            tracking_contacts_shaped_vel=thr.tracking_contacts_shaped_vel,
        )
        self.task_thresholds = f32(
            [thr_map[k] * scales.get(k, 0.0) * self.dt for k in curr.TASK_KEYS])

        # actuator network ------------------------------------------------
        if cfg.control.control_type == "actuator_net":
            self.actuator_params = actuator_net.load(device=dev)
            # block-diagonal weights for the in-kernel evaluation
            self.actuator_blockdiag = megastep_ops.blockdiag_actuator_weights(
                self.actuator_params, device=dev)
        else:
            self.actuator_params = None
            self.actuator_blockdiag = None

        # height measurement points (legged_robot.py:1756-1770)
        if cfg.terrain.measure_heights:
            gx, gy = np.meshgrid(np.asarray(cfg.terrain.measured_points_x),
                                 np.asarray(cfg.terrain.measured_points_y),
                                 indexing="ij")
            self.height_points = f32(
                np.stack([gx.reshape(-1), gy.reshape(-1),
                          np.zeros(gx.size)], axis=-1))
            self.num_height_points = gx.size
        else:
            self.height_points = None
            self.num_height_points = 0

        # derived intervals (legged_robot.py:1716-1732)
        self.resample_interval = int(cfg.commands.resampling_time / self.dt)
        self.resample_interval_arr = None
        if self.eval_commands_differ:
            # per-split resampling cadence
            ev_interval = int(eval_cfg.commands.resampling_time / self.dt)
            self.resample_interval_arr = torch.tensor(np.concatenate([
                np.full(self.num_train_envs, self.resample_interval),
                np.full(self.num_eval_envs, ev_interval)]),
                dtype=torch.int32, device=dev)
        self.rand_interval = int(np.ceil(cfg.domain_rand.rand_interval_s / self.dt))
        self.push_interval = int(np.ceil(cfg.domain_rand.push_interval_s / self.dt))
        self.gravity_rand_interval = int(
            np.ceil(cfg.domain_rand.gravity_rand_interval_s / self.dt))
        self.gravity_rand_duration = int(np.ceil(
            self.gravity_rand_interval * cfg.domain_rand.gravity_impulse_duration))
        self._dr_ranges = {}

        # the step's CUDA graph (module docstring): captured on the second
        # call of `step` where the env takes one
        self.graphed = (self.device.type == "cuda"
                        and not self.rows.distributed
                        and cfg.sim.use_pallas_contact and cfg.sim.megastep)
        self._graph = None
        self._stepped = False

    @staticmethod
    def _field(arrays, dev) -> engine.Terrain:
        """The engine terrain of built tiles: flat ground when every tile
        is flat (the MoB train config: no lookups), else the heightfield."""
        if np.abs(arrays.height).max() == 0.0:
            return engine.flat_terrain(dev)
        return engine.make_heightfield_terrain(
            arrays.height, arrays.horizontal_scale, arrays.origin_xy,
            device=dev)

    # -- random draws -------------------------------------------------------
    def _uniform(self, gen, shape, lo=0.0, hi=1.0):
        """U[lo, hi) of `shape` on the env's device; lo/hi scalars or
        tensors that broadcast against `shape`.  One draw for the whole
        batch (gravity): every rank makes the same."""
        u = torch.rand(tuple(shape), generator=gen, device=self.device)
        return lo + u * (hi - lo)

    def _env_uniform(self, gen, shape_extra=(), lo=0.0, hi=1.0):
        """U[lo, hi) of (num_envs,) + `shape_extra`: the rank's rows of the
        draw over the global batch, so every rank's stream stays the one
        rank's (parallel/mesh.py)."""
        u = torch.rand((self.num_envs_global,) + tuple(shape_extra),
                       generator=gen, device=self.device)
        return lo + self.rows.take(u) * (hi - lo)

    # -- noise ------------------------------------------------------------
    def _make_noise_vec(self) -> torch.Tensor:
        """Observation noise scales (legged_robot.py:1053-1120)."""
        cfg = self.cfg
        ns, osc = cfg.noise_scales, cfg.obs_scales
        lvl = cfg.noise.noise_level
        parts = [np.ones(3) * ns.gravity * lvl]
        if cfg.env.observe_command:
            parts.append(np.zeros(cfg.commands.num_commands))
        parts.append(np.ones(12) * ns.dof_pos * lvl * osc.dof_pos)
        parts.append(np.ones(12) * ns.dof_vel * lvl * osc.dof_vel)
        parts.append(np.zeros(12))  # actions
        if cfg.env.observe_two_prev_actions:
            parts.append(np.zeros(12))
        if cfg.env.observe_timing_parameter:
            parts.append(np.zeros(1))
        if cfg.env.observe_clock_inputs:
            parts.append(np.zeros(4))
        if cfg.env.observe_vel:
            parts = [np.ones(3) * ns.lin_vel * lvl * osc.lin_vel,
                     np.ones(3) * ns.ang_vel * lvl * osc.ang_vel] + parts
        if cfg.env.observe_only_lin_vel:
            parts = [np.ones(3) * ns.lin_vel * lvl * osc.lin_vel] + parts
        if cfg.env.observe_yaw:
            parts.append(np.zeros(1))
        if cfg.env.observe_contact_states:
            parts.append(np.ones(4) * ns.contact_states * lvl)
        vec = np.concatenate(parts)
        assert vec.shape[0] == self.num_obs, (vec.shape, self.num_obs)
        return torch.tensor(vec, dtype=torch.float32, device=self.device)

    # -- per-env domain-rand ranges (train/eval split) ---------------------
    def _dr_split(self, flag_name: str, range_name: str):
        """(lo, hi, on) per-env tensors of a domain_rand field: the train
        slice's range, then the eval slice's (reference applies
        eval_cfg.domain_rand to the eval envs, legged_robot.py:531-544).
        Built once per field."""
        key = (flag_name, range_name)
        if key not in self._dr_ranges:
            T, E = self.num_train_envs, self.num_eval_envs
            tr = self.cfg.domain_rand
            ev = self.eval_cfg.domain_rand if self.eval_cfg else tr
            tr_r, ev_r = getattr(tr, range_name), getattr(ev, range_name)
            lo = np.concatenate([np.full(T, tr_r[0]), np.full(E, ev_r[0])])
            hi = np.concatenate([np.full(T, tr_r[1]), np.full(E, ev_r[1])])
            on = np.concatenate([
                np.full(T, bool(getattr(tr, flag_name))),
                np.full(E, bool(getattr(ev, flag_name)))])
            self._dr_ranges[key] = tuple(
                torch.tensor(x, dtype=d, device=self.device)
                for x, d in ((lo, torch.float32), (hi, torch.float32),
                             (on, torch.bool)))
        return self._dr_ranges[key]

    def _dr_uniform(self, gen, flag_name, range_name, default, shape_extra=()):
        """Per-env uniform sample inside the split-aware range; `default`
        where that randomization is off for the env's slice."""
        lo, hi, on = self._dr_split(flag_name, range_name)
        u = self._env_uniform(gen, shape_extra)
        ex = (slice(None),) + (None,) * len(shape_extra)
        return torch.where(on[ex], lo[ex] + u * (hi[ex] - lo[ex]),
                           float(default))

    # -- initialization ---------------------------------------------------
    def init_state(self, gen: torch.Generator) -> EnvState:
        """Fresh state with creation-time DR applied (reference
        _create_envs + _init_custom_buffers + _randomize_rigid_body_props,
        legged_robot.py:1481-1571, 1260-1297)."""
        N = self.num_envs
        cfg = self.cfg
        dev = self.device
        dr = cfg.domain_rand

        friction = self._dr_uniform(
            gen, "randomize_friction", "friction_range", 1.0)
        restitution = self._dr_uniform(
            gen, "randomize_restitution", "restitution_range", 0.0)
        payload = self._dr_uniform(
            gen, "randomize_base_mass", "added_mass_range", 0.0)
        com_disp = self._dr_uniform(
            gen, "randomize_com_displacement", "com_displacement_range",
            0.0, shape_extra=(3,))
        gravity_offset = (self._uniform(gen, (3,), *dr.gravity_range)
                          if dr.randomize_gravity
                          else torch.zeros(3, device=dev))

        motor_strengths, motor_offsets, kp_f, kd_f = self._sample_dof_props(
            gen, N)

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        phys = engine.PhysicsState(
            base_pos=self.env_origins + self._init_pos,
            base_quat=self._init_rot.repeat(N, 1),
            base_lin_vel=z(N, 3),
            base_ang_vel=z(N, 3),
            q=self.default_dof_pos.repeat(N, 1),
            qd=z(N, 12),
        )
        n_terms = len(self.reward_names)
        z12 = z(N, 12)
        blk = engine.MEGASTEP_BLOCK
        state = EnvState(
            phys=phys,
            rng=gen,
            actions=z12, last_actions=z12, last_last_actions=z12,
            joint_pos_target=z12, last_joint_pos_target=z12,
            last_last_joint_pos_target=z12,
            last_dof_vel=z12,
            lag_buffer=z(N, dr.lag_timesteps + 1, 12),
            torques=z12,
            joint_pos_err_last=z12, joint_pos_err_last_last=z12,
            joint_vel_last=z12, joint_vel_last_last=z12,
            episode_length=z(N, dtype=torch.int32),
            common_step=z(dtype=torch.int32),
            commands=z(N, 15),
            gait_indices=z(N),
            clock_inputs=z(N, 4),
            desired_contact_states=z(N, 4),
            foot_indices=z(N, 4),
            contact_forces=z(N, self.model.num_report_bodies, 3),
            foot_positions=z(N, 4, 3),
            foot_velocities=z(N, 4, 3),
            prev_foot_velocities=z(N, 4, 3),
            last_contacts=z(N, 4, dtype=torch.bool),
            payloads=payload,
            com_displacements=com_disp,
            friction_coeffs=friction,
            restitutions=restitution,
            motor_strengths=motor_strengths,
            motor_offsets=motor_offsets,
            Kp_factors=kp_f,
            Kd_factors=kd_f,
            gravity_offset=gravity_offset,
            episode_sums=z(N, n_terms + 1),
            command_sums=z(N, len(COMMAND_SUM_KEYS)),
            curriculum=curr.init_state(cfg.commands, self.curr_grid,
                                       device=dev),
            curriculum_eval=(
                curr.init_state(self.eval_cfg.commands, self.curr_grid_eval,
                                device=dev)
                if self.eval_commands_differ else None),
            env_command_bins=z(N, dtype=torch.int32),
            env_command_categories=z(N, dtype=torch.int32),
            obs_history=z(N, self.num_obs_history),
            contact_lam_t=z(self.model.cp_body.shape[0], 3,
                            -(-N // blk) * blk),
        )
        return state

    def _sample_dof_props(self, gen, N):
        """Motor strength/offset/Kp/Kd DR (legged_robot.py:645-665)."""
        ones = torch.ones((1, 12), device=self.device)
        # motor strength / Kp / Kd: one factor per env broadcast to 12 joints
        ms = self._dr_uniform(
            gen, "randomize_motor_strength", "motor_strength_range",
            1.0)[:, None] * ones
        mo = self._dr_uniform(
            gen, "randomize_motor_offset", "motor_offset_range", 0.0,
            shape_extra=(12,))
        kp = self._dr_uniform(
            gen, "randomize_Kp_factor", "Kp_factor_range",
            1.0)[:, None] * ones
        kd = self._dr_uniform(
            gen, "randomize_Kd_factor", "Kd_factor_range",
            1.0)[:, None] * ones
        return ms, mo, kp, kd

    # -- torque model ------------------------------------------------------
    def _compute_torques(self, state: EnvState):
        """One substep of the torque pipeline (legged_robot.py:907-946).
        Returns (torques, joint-position target, lag buffer, updated
        actuator-history fields)."""
        cfg = self.cfg
        actions_scaled = state.actions * cfg.control.action_scale
        actions_scaled = actions_scaled * self._hip_scale[None, :]

        if cfg.domain_rand.randomize_lag_timesteps:
            lag = torch.cat(
                [state.lag_buffer[:, 1:], actions_scaled[:, None, :]], dim=1)
            target = lag[:, 0] + self.default_dof_pos[None, :]
        else:
            lag = state.lag_buffer
            target = actions_scaled + self.default_dof_pos[None, :]

        q, qd = state.phys.q, state.phys.qd
        if cfg.control.control_type == "actuator_net":
            err = q - target + state.motor_offsets
            tau = actuator_net.eval_torques(
                self.actuator_params,
                err, state.joint_pos_err_last, state.joint_pos_err_last_last,
                qd, state.joint_vel_last, state.joint_vel_last_last)
            new_hist = dict(
                joint_pos_err_last_last=state.joint_pos_err_last,
                joint_pos_err_last=err,
                joint_vel_last_last=state.joint_vel_last,
                joint_vel_last=qd,
            )
        elif cfg.control.control_type == "P":
            tau = (self.p_gains[None, :] * state.Kp_factors
                   * (target - q + state.motor_offsets)
                   - self.d_gains[None, :] * state.Kd_factors * qd)
            new_hist = {}
        else:
            raise NameError(
                f"Unknown controller type: {cfg.control.control_type}")

        tau = tau * state.motor_strengths
        tau = torch.maximum(torch.minimum(tau, self.torque_limits),
                            -self.torque_limits)
        return tau, target, lag, new_hist

    def _substep_targets(self, state: EnvState):
        """Per-substep joint-position targets for one control step — the
        decimation-unrolled form of the lag-buffer shift (reference
        legged_robot.py:907-918): substep s reads lag entry s+1 (or the
        fresh action once the buffer drains).  Returns (targets (N, D, 12)
        incl. default_dof_pos, final lag buffer)."""
        cfg = self.cfg
        D = cfg.control.decimation
        N = state.actions.shape[0]
        actions_scaled = state.actions * cfg.control.action_scale
        actions_scaled = actions_scaled * self._hip_scale[None, :]
        if cfg.domain_rand.randomize_lag_timesteps:
            L = state.lag_buffer                     # (N, T, 12)
            T = L.shape[1]
            cols = [L[:, s + 1] if s + 1 < T else actions_scaled
                    for s in range(D)]
            tgt = torch.stack(cols, dim=1) \
                + self.default_dof_pos[None, None, :]
            tail = actions_scaled[:, None, :].expand(N, min(D, T), 12)
            lag_final = (torch.cat([L[:, D:], tail], dim=1)
                         if D < T else tail[:, :T].contiguous())
        else:
            tgt = (actions_scaled + self.default_dof_pos[None, :]
                   )[:, None].expand(N, D, 12)
            lag_final = state.lag_buffer
        return tgt, lag_final

    # -- observation -------------------------------------------------------
    def _compute_obs(self, state: EnvState, base_lin_vel_b, base_ang_vel_b,
                     projected_gravity, gen):
        """Observation assembly (legged_robot.py:302-377)."""
        cfg = self.cfg
        osc = cfg.obs_scales
        parts = [projected_gravity]
        if cfg.env.observe_command:
            parts.append(state.commands[:, :cfg.commands.num_commands]
                         * self.commands_scale[None, :])
        parts.append((state.phys.q - self.default_dof_pos[None, :]) * osc.dof_pos)
        parts.append(state.phys.qd * osc.dof_vel)
        parts.append(state.actions)
        if cfg.env.observe_two_prev_actions:
            parts.append(state.last_actions)
        if cfg.env.observe_timing_parameter:
            parts.append(state.gait_indices[:, None])
        if cfg.env.observe_clock_inputs:
            parts.append(state.clock_inputs)
        obs = torch.cat(parts, dim=-1)
        if cfg.env.observe_vel:
            obs = torch.cat(
                [base_lin_vel_b * osc.lin_vel, base_ang_vel_b * osc.ang_vel, obs],
                dim=-1)
        if cfg.env.observe_only_lin_vel:
            obs = torch.cat([base_lin_vel_b * osc.lin_vel, obs], dim=-1)
        if cfg.env.observe_yaw:
            fwd = qops.quat_apply(state.phys.base_quat, self._x_axis)
            heading = torch.atan2(fwd[:, 1], fwd[:, 0])[:, None]
            obs = torch.cat([obs, heading], dim=-1)
        if cfg.env.observe_contact_states:
            cs = (state.contact_forces[:, self._feet_idx, 2] > 1.0) * 1.0
            obs = torch.cat([obs, cs], dim=-1)
        if cfg.noise.add_noise:
            noise = 2 * self._env_uniform(gen, obs.shape[1:]) - 1
            obs = obs + noise * self.noise_scale_vec[None, :]
        return obs

    def _compute_privileged_obs(self, state: EnvState, base_lin_vel_b):
        """Privileged observation assembly (legged_robot.py:380-491)."""
        cfg = self.cfg
        nrm = cfg.normalization
        parts = []

        def scale_shift(rng_):
            return 2.0 / (rng_[1] - rng_[0]), (rng_[1] + rng_[0]) / 2.0

        if cfg.env.priv_observe_friction:
            s, sh = scale_shift(nrm.friction_range)
            parts.append(((state.friction_coeffs - sh) * s)[:, None])
        if cfg.env.priv_observe_restitution:
            s, sh = scale_shift(nrm.restitution_range)
            parts.append(((state.restitutions - sh) * s)[:, None])
        if cfg.env.priv_observe_base_mass:
            s, sh = scale_shift(nrm.added_mass_range)
            parts.append(((state.payloads - sh) * s)[:, None])
        if cfg.env.priv_observe_com_displacement:
            s, sh = scale_shift(nrm.com_displacement_range)
            parts.append((state.com_displacements - sh) * s)
        if cfg.env.priv_observe_motor_strength:
            s, sh = scale_shift(nrm.motor_strength_range)
            parts.append((state.motor_strengths - sh) * s)
        if cfg.env.priv_observe_motor_offset:
            s, sh = scale_shift(nrm.motor_offset_range)
            parts.append((state.motor_offsets - sh) * s)
        if cfg.env.priv_observe_body_height:
            s, sh = scale_shift(nrm.body_height_range)
            parts.append(((state.phys.base_pos[:, 2] - sh) * s)[:, None])
        if cfg.env.priv_observe_body_velocity:
            s, sh = scale_shift(nrm.body_velocity_range)
            parts.append((base_lin_vel_b - sh) * s)
        if cfg.env.priv_observe_clock_inputs:
            parts.append(state.clock_inputs)
        if cfg.env.priv_observe_desired_contact_states:
            parts.append(state.desired_contact_states)
        if not parts:
            return torch.zeros((self.num_envs, 0), device=self.device)
        priv = torch.cat(parts, dim=-1)
        assert priv.shape[1] == self.num_privileged_obs, (
            priv.shape, self.num_privileged_obs)
        return priv

    # -- gait clocks -------------------------------------------------------
    def _step_contact_targets(self, state: EnvState):
        """Gait clock machinery (legged_robot.py:826-905)."""
        cfg = self.cfg
        if not cfg.env.observe_gait_commands:
            return state.gait_indices, state.clock_inputs, \
                state.desired_contact_states, state.foot_indices
        cmds = state.commands
        freq, phases, offsets, bounds, durations = (
            cmds[:, 4], cmds[:, 5], cmds[:, 6], cmds[:, 7], cmds[:, 8])
        gi = torch.remainder(state.gait_indices + self.dt * freq, 1.0)
        if cfg.commands.pacing_offset:
            raw = [gi + phases + offsets + bounds, gi + bounds,
                   gi + offsets, gi + phases]
        else:
            raw = [gi + phases + offsets + bounds, gi + offsets,
                   gi + bounds, gi + phases]
        raw = torch.stack(raw, dim=1)                      # (N, 4) FL FR RL RR
        foot_indices = torch.remainder(raw, 1.0)
        dur = durations[:, None]
        rem = torch.remainder(raw, 1.0)
        stance = rem * (0.5 / dur)
        swing = 0.5 + (rem - dur) * (0.5 / (1 - dur))
        xform = torch.where(rem < dur, stance,
                            torch.where(rem > dur, swing, rem))
        clock = torch.sin(2 * math.pi * xform)
        kappa = cfg.rewards.kappa_gait_probs

        def cdf(x):
            return torch.special.ndtr(x / kappa)

        x = torch.remainder(xform, 1.0)
        desired = (cdf(x) * (1 - cdf(x - 0.5))
                   + cdf(x - 1) * (1 - cdf(x - 1.5)))
        return gi, clock, desired, foot_indices

    # -- reset helpers -----------------------------------------------------
    def _sample_reset_state(self, state: EnvState, gen):
        """Per-env reset samples (reference _reset_dofs/_reset_root_states,
        legged_robot.py:948-1001). Returns a full-batch candidate."""
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        q = self.default_dof_pos[None, :] * self._env_uniform(
            gen, (12,), 0.5, 1.5)
        pos = self.env_origins + self._init_pos
        span = self._init_span
        xy = self._env_uniform(gen, (2,), -span, span)
        if cfg.terrain.mesh_type in ("heightfield", "trimesh"):
            pos = torch.cat([pos[:, :2] + xy + self._init_offset, pos[:, 2:]],
                            dim=1)
        yaw = self._env_uniform(gen, (), -cfg.terrain.yaw_init_range,
                                cfg.terrain.yaw_init_range)
        quat = qops.quat_from_angle_axis(yaw, self._z_axis)
        vel6 = self._env_uniform(gen, (6,), -0.5, 0.5)
        return engine.PhysicsState(
            base_pos=pos, base_quat=quat,
            base_lin_vel=vel6[:, :3], base_ang_vel=vel6[:, 3:],
            q=q, qd=torch.zeros((N, 12), device=dev))

    def dynamics_params(self, state: EnvState):
        """(gravity (3,), DynamicsParams) of one control step from `state`.
        Gravity is -9.8 here as in the reference step."""
        gravity = state.gravity_offset + self._gravity_base
        dyn = engine.DynamicsParams(
            payload=state.payloads,
            com_displacement=state.com_displacements,
            friction=state.friction_coeffs,
            restitution=state.restitutions,
            gravity=gravity[None, :].repeat(self.num_envs, 1),
        )
        return gravity, dyn

    def _ctrl(self, state: EnvState):
        """The torque model's inputs to the control-step kernel from
        `state`: ("actuator_net", block-diagonal weights, (el, ell, vl,
        vll)) or ("P", kp, kd)."""
        if self.cfg.control.control_type == "actuator_net":
            return ("actuator_net", self.actuator_blockdiag,
                    (state.joint_pos_err_last, state.joint_pos_err_last_last,
                     state.joint_vel_last, state.joint_vel_last_last))
        return ("P", self.p_gains[None, :] * state.Kp_factors,
                self.d_gains[None, :] * state.Kd_factors)

    def control_step_inputs(self, state: EnvState):
        """What one control step feeds the control-step kernel from `state`
        (its `actions` already clipped): (gravity (3,), DynamicsParams,
        raw targets (N, D, 12), final lag buffer, effective targets,
        ctrl tuple, cross-step impulse seed or None)."""
        cfg = self.cfg
        gravity, dyn = self.dynamics_params(state)
        tgt_raw, lag_final = self._substep_targets(state)
        if cfg.control.control_type == "actuator_net":
            tgt_eff = tgt_raw - state.motor_offsets[:, None, :]
        else:
            tgt_eff = tgt_raw + state.motor_offsets[:, None, :]
        ctrl = self._ctrl(state)
        # exact mode starts every contact solve cold: no cross-step seed
        cross_warm = (self.sim_params.contact_warm_start
                      and self.sim_params.contact_cross_step_warm_start
                      and self.reuse_matrices)
        lam_in = state.contact_lam_t if cross_warm else None
        return gravity, dyn, tgt_raw, lag_final, tgt_eff, ctrl, lam_in

    # -- main step ---------------------------------------------------------
    def step(self, state: EnvState, actions: torch.Tensor):
        """One control step: (state, actions) -> (state, obs_dict, reward,
        done, StepInfo).  Where the env takes a CUDA graph (`graphed`), the
        first call runs eagerly, the second captures the step and every
        call from then on replays it; a call the graph does not fit (other
        shapes or structure) runs eagerly."""
        global eager_steps
        if self.graphed:
            if self._graph is None and self._stepped:
                self._graph = _StepGraph(self, state, actions)
            if self._graph is not None:
                out = self._graph.replay(state, actions)
                if out is not None:
                    return out
            self._stepped = True
        eager_steps += 1
        return self._step(state, actions)

    def _graph_operands(self):
        """The device tensors the step's kernel reads that the env does not
        hold itself: the packed actuator weights, which ops/megastep caches
        (and may drop)."""
        if self.actuator_blockdiag is None:
            return ()
        return (megastep_ops.team_actuator_weights(*self.actuator_blockdiag),)

    def _step(self, state: EnvState, actions: torch.Tensor):
        """The step itself, eagerly (see `step`)."""
        cfg = self.cfg
        N = self.num_envs
        m = self.model
        gen = state.rng
        dev = self.device

        # 1. clip actions (legged_robot.py:66-67)
        clip_a = cfg.normalization.clip_actions
        actions = torch.clamp(actions.to(dev), -clip_a, clip_a)
        state = state._replace(actions=actions,
                               prev_foot_velocities=state.foot_velocities)

        # 2. decimation loop (legged_robot.py:74-81)
        D = cfg.control.decimation
        if not self.sim_params.use_pallas_contact:
            # the dense route: stock torch ops, no hand kernel.  Reuse
            # mode: one N-major cache anchored at the control step's first
            # geometry, contact points advanced at velocity level, the feet
            # from them; exact mode: FK, M^-1 and the contact solve anew
            # every substep, the feet from FK.  Every solve starts cold;
            # `contact_lam_t` is left untouched.
            gravity, dyn = self.dynamics_params(state)
            if self.reuse_matrices:
                cache = engine.build_dynamics_cache(
                    m, self.sim_params, state.phys, dyn, self.terrain)
                p_cp = cache.p_cp
            for _ in range(D):
                tau, target, lag, hist = self._compute_torques(state)
                if self.reuse_matrices:
                    phys2, cinfo_last, p_cp = engine.physics_substep_cached(
                        m, self.sim_params, state.phys, tau, dyn,
                        self.terrain, cache, p_cp)
                else:
                    phys2, cinfo_last = engine.physics_substep(
                        m, self.sim_params, state.phys, tau, dyn,
                        self.terrain)
                state = state._replace(phys=phys2, torques=tau,
                                       joint_pos_target=target,
                                       lag_buffer=lag, **hist)
            if self.reuse_matrices:
                foot_positions, foot_velocities = \
                    engine.foot_state_from_cache(m, cache, state.phys, p_cp)
            else:
                foot_positions, foot_velocities = \
                    engine.foot_positions_velocities(m, state.phys)
        elif cfg.sim.megastep and not self.reuse_matrices and self.rough:
            # exact mode on a heightfield (the kernel's exact variant is
            # flat-ground only): D launches of one substep each in reuse
            # mode, every one from a fresh cache and fresh terrain samples
            # at the current state, cold-started, the torque model's
            # histories carried from launch to launch
            gravity, dyn, tgt_raw, lag_final, tgt_eff, _, _ = \
                self.control_step_inputs(state)
            for si in range(D):
                phys2, lam_t, p_cp_t, p_cp_prev_t, torques, hist = \
                    engine.control_step_megakernel(
                        m, self.sim_params, state.phys, dyn, self.terrain,
                        tgt_eff[:, si:si + 1], state.motor_strengths,
                        self.torque_limits, self._ctrl(state), 1)
                state = state._replace(phys=phys2, torques=torques, **hist)
            state = state._replace(
                joint_pos_target=tgt_raw[:, -1], lag_buffer=lag_final)
        elif cfg.sim.megastep:
            # one launch of the whole-control-step kernel: torque model +
            # all decimation substeps + integration, J/W built in-kernel;
            # the cache anchored at the entry state (reuse mode) or rebuilt
            # in the kernel before every substep (exact mode, which leaves
            # `contact_lam_t` untouched)
            gravity, dyn, tgt_raw, lag_final, tgt_eff, ctrl, lam_in = \
                self.control_step_inputs(state)
            cross_warm = lam_in is not None
            phys2, lam_t, p_cp_t, p_cp_prev_t, torques, hist = \
                engine.control_step_megakernel(
                    m, self.sim_params, state.phys, dyn, self.terrain,
                    tgt_eff, state.motor_strengths, self.torque_limits,
                    ctrl, D, lam_in_t=lam_in,
                    exact=not self.reuse_matrices)
            state = state._replace(phys=phys2, torques=torques, **hist)
            if cross_warm:
                state = state._replace(contact_lam_t=lam_t)
            state = state._replace(
                joint_pos_target=tgt_raw[:, -1], lag_buffer=lag_final)
        else:
            # per-substep kernels: the torque model between the launches.
            # Reuse mode: one cache anchored at the control step's first
            # geometry, contact points advanced at velocity level across
            # substeps.  Exact mode: a fresh cache (FK/CRBA/M^-1/J/W) and
            # fresh FK points per substep.  Every substep cold-starts the
            # solver; `contact_lam_t` is left untouched.
            gravity, dyn = self.dynamics_params(state)
            reuse = cfg.sim.reuse_matrices
            cache = p_cp_t = p_cp_prev_t = lam_t = None
            if reuse:
                cache = engine.build_dynamics_cache(
                    m, self.sim_params, state.phys, dyn, self.terrain)
                p_cp_t = cache.pallas_ops.p_cp_t
            for _ in range(D):
                tau, target, lag, hist = self._compute_torques(state)
                if not reuse:
                    cache = engine.build_dynamics_cache(
                        m, self.sim_params, state.phys, dyn, self.terrain)
                    p_cp_t = cache.pallas_ops.p_cp_t
                p_cp_prev_t = p_cp_t
                phys2, lam_t, p_cp_t = engine.physics_substep_cached(
                    m, self.sim_params, state.phys, tau, dyn, self.terrain,
                    cache, p_cp_t)
                state = state._replace(phys=phys2, torques=tau,
                                       joint_pos_target=target,
                                       lag_buffer=lag, **hist)
        if self.sim_params.use_pallas_contact:
            cinfo_last = engine.contact_report_from_lam_t(
                m, lam_t, self.sim_params.dt, N)
            foot_positions, foot_velocities = engine.foot_state_from_pcp_t(
                m, p_cp_t, p_cp_prev_t, self.sim_params.dt, N)
        contact_forces = cinfo_last.report_forces

        # 3. kinematic quantities (legged_robot.py:102-115)
        phys = state.phys
        episode_length = state.episode_length + 1
        common_step = state.common_step + 1
        base_lin_vel_b = qops.quat_rotate_inverse(phys.base_quat, phys.base_lin_vel)
        base_ang_vel_b = qops.quat_rotate_inverse(phys.base_quat, phys.base_ang_vel)
        gravity_unit = gravity / torch.linalg.norm(gravity)
        gravity_vec = gravity_unit[None, :].repeat(N, 1)
        projected_gravity = qops.quat_rotate_inverse(phys.base_quat, gravity_vec)

        # 4. teleport (legged_robot.py:1028-1051)
        if cfg.terrain.teleport_robots and cfg.terrain.mesh_type in (
                "heightfield", "trimesh"):
            phys = self._teleport(phys)

        state = state._replace(
            phys=phys, episode_length=episode_length, common_step=common_step,
            contact_forces=contact_forces, foot_positions=foot_positions,
            foot_velocities=foot_velocities)

        # 5. command resampling w/ curriculum (legged_robot.py:683-686)
        interval = (self.resample_interval if self.resample_interval_arr is None
                    else self.resample_interval_arr)
        resample_mask = (episode_length % interval) == 0
        state = self._resample_commands(state, resample_mask, gen)

        # 6. gait clocks (legged_robot.py:687)
        gi, clock, desired, foot_idx = self._step_contact_targets(state)
        state = state._replace(gait_indices=gi, clock_inputs=clock,
                               desired_contact_states=desired,
                               foot_indices=foot_idx)

        # 7. push robots (legged_robot.py:693-694, 1017-1026)
        if cfg.domain_rand.push_robots:
            push_mask = (episode_length % self.push_interval) == 0
            pv = self._env_uniform(gen, (2,),
                                   -cfg.domain_rand.max_push_vel_xy,
                                   cfg.domain_rand.max_push_vel_xy)
            new_lin = torch.where(
                push_mask[:, None],
                torch.cat([pv, state.phys.base_lin_vel[:, 2:]], -1),
                state.phys.base_lin_vel)
            state = state._replace(phys=state.phys._replace(base_lin_vel=new_lin))

        # 8. periodic dof-prop DR (legged_robot.py:696-699)
        dof_rand_mask = (episode_length % self.rand_interval) == 0
        state = self._apply_dof_props_mask(state, dof_rand_mask, gen)

        # 9. gravity DR schedule (legged_robot.py:701-705)
        if cfg.domain_rand.randomize_gravity:
            new_g = self._uniform(gen, (3,), cfg.domain_rand.gravity_range[0],
                                  cfg.domain_rand.gravity_range[1])
            go = torch.where((common_step % self.gravity_rand_interval) == 0,
                             new_g, state.gravity_offset)
            go = torch.where(
                ((common_step - self.gravity_rand_duration)
                 % self.gravity_rand_interval) == 0,
                torch.zeros(3, device=dev), go)
            state = state._replace(gravity_offset=go)

        # 10. termination (legged_robot.py:138-148)
        term_f = torch.linalg.norm(
            state.contact_forces[:, self._termination_idx, :], dim=-1)
        reset = torch.any(term_f > 1.0, dim=1)
        time_out = episode_length > self.max_episode_length
        reset = reset | time_out
        if cfg.rewards.use_terminal_body_height:
            body_height = state.phys.base_pos[:, 2] - self._measured_ground(state)
            reset = reset | (body_height < cfg.rewards.terminal_body_height)
        # envelope guard: an env whose base velocity saturates the
        # integrator caps (SimParams.max_base_lin/ang_vel) is in an
        # unrecoverable crash state; the per-component clamp that holds it
        # finite is not momentum-consistent, so terminate it
        sp = self.sim_params
        env_exit = (
            torch.amax(torch.abs(state.phys.base_lin_vel), dim=-1)
            >= 0.99 * sp.max_base_lin_vel) | (
            torch.amax(torch.abs(state.phys.base_ang_vel), dim=-1)
            >= 0.99 * sp.max_base_ang_vel)
        reset = reset | env_exit

        # 11. rewards (legged_robot.py:263-300)
        ctx = rew_mod.RewardCtx(
            cfg=cfg, dt=self.dt, commands=state.commands,
            base_pos=state.phys.base_pos, base_quat=state.phys.base_quat,
            base_lin_vel=base_lin_vel_b, base_ang_vel=base_ang_vel_b,
            projected_gravity=projected_gravity, gravity_vec=gravity_vec,
            dof_pos=state.phys.q, default_dof_pos=self.default_dof_pos,
            dof_vel=state.phys.qd, last_dof_vel=state.last_dof_vel,
            torques=state.torques, actions=state.actions,
            last_actions=state.last_actions,
            last_last_actions=state.last_last_actions,
            joint_pos_target=state.joint_pos_target,
            last_joint_pos_target=state.last_joint_pos_target,
            last_last_joint_pos_target=state.last_last_joint_pos_target,
            contact_forces=state.contact_forces,
            foot_velocities=state.foot_velocities,
            prev_foot_velocities=state.prev_foot_velocities,
            foot_positions=state.foot_positions,
            desired_contact_states=state.desired_contact_states,
            foot_indices=state.foot_indices,
            last_contacts=state.last_contacts,
            dof_pos_limits=self.dof_pos_limits,
            feet_indices=self._feet_idx,
            penalised_indices=self._penalised_idx,
        )
        rew_total, episode_sums, command_sums = self._compute_reward(
            ctx, state, base_lin_vel_b, base_ang_vel_b)
        new_last_contacts = state.contact_forces[:, self._feet_idx, 2] > 1.0
        state = state._replace(last_contacts=new_last_contacts,
                               episode_sums=episode_sums,
                               command_sums=command_sums)

        # 12. masked auto-reset (legged_robot.py:150-239); episode stats
        # split by train/eval slice
        T = self.num_train_envs
        zero_f = torch.zeros((), device=dev)
        done_sums = torch.where(reset[:, None], state.episode_sums, zero_f)
        done_len = torch.where(reset, episode_length,
                               torch.zeros_like(episode_length))
        ep_sums_done = torch.sum(done_sums[:T], dim=0)
        ep_count_done = torch.sum(reset[:T])
        ep_len_done = torch.sum(done_len[:T])
        eval_ep_sums_done = torch.sum(done_sums[T:], dim=0)
        eval_ep_count_done = torch.sum(reset[T:])
        eval_ep_len_done = torch.sum(done_len[T:])
        state = self._reset_envs(state, reset, gen)

        # 13. observations (legged_robot.py:302+) on post-reset state
        phys = state.phys
        base_lin_vel_b2 = qops.quat_rotate_inverse(phys.base_quat, phys.base_lin_vel)
        base_ang_vel_b2 = qops.quat_rotate_inverse(phys.base_quat, phys.base_ang_vel)
        projected_gravity2 = qops.quat_rotate_inverse(phys.base_quat, gravity_vec)
        obs = self._compute_obs(state, base_lin_vel_b2, base_ang_vel_b2,
                                projected_gravity2, gen)
        clip_o = cfg.normalization.clip_observations
        obs = torch.clamp(obs, -clip_o, clip_o)
        priv_obs = self._compute_privileged_obs(state, base_lin_vel_b2)
        priv_obs = torch.clamp(priv_obs, -clip_o, clip_o)
        obs_history = torch.cat(
            [state.obs_history[:, self.num_obs:], obs], dim=-1)

        # 14. shift last_* buffers (legged_robot.py:126-131)
        state = state._replace(
            obs_history=obs_history,
            last_last_actions=state.last_actions,
            last_actions=state.actions,
            last_last_joint_pos_target=state.last_joint_pos_target,
            last_joint_pos_target=state.joint_pos_target,
            last_dof_vel=state.phys.qd,
        )

        obs_dict = {"obs": obs, "privileged_obs": priv_obs,
                    "obs_history": obs_history}
        info = StepInfo(
            time_outs=time_out, env_bins=state.env_command_bins,
            ep_sums_done=ep_sums_done, ep_count_done=ep_count_done,
            ep_len_done=ep_len_done,
            eval_ep_sums_done=eval_ep_sums_done,
            eval_ep_count_done=eval_ep_count_done,
            eval_ep_len_done=eval_ep_len_done,
            torques=state.torques,
            envelope_exits=torch.sum(env_exit.to(torch.float32)))
        return state, obs_dict, rew_total, reset, info

    def _measured_ground(self, state: EnvState) -> torch.Tensor:
        """Mean measured terrain height under each robot (N,), or 0 on flat
        ground (reference _get_heights, legged_robot.py:1772-1806; the grid
        of sample points is yaw-rotated around the base)."""
        if not self.cfg.terrain.measure_heights or self.height_points is None:
            return torch.zeros(self.num_envs, device=self.device)
        pts = qops.quat_apply_yaw(
            state.phys.base_quat[:, None, :],
            self.height_points[None, :, :]) + state.phys.base_pos[:, None, :]
        h, _ = self.terrain.lookup(pts[..., 0], pts[..., 1])
        return torch.mean(h, dim=-1)

    # -- reward assembly ---------------------------------------------------
    def make_reward_ctx(self, state: EnvState) -> rew_mod.RewardCtx:
        """A RewardCtx from an EnvState alone (body-frame kinematics
        recomputed, gravity straight down): the out-of-step entry of the
        eval-metrics library's per-term rewards (reference
        eval_metrics/metrics.py:66-73)."""
        phys = state.phys
        gravity_vec = torch.tensor([0.0, 0.0, -1.0], device=self.device
                                   )[None, :].repeat(self.num_envs, 1)
        return rew_mod.RewardCtx(
            cfg=self.cfg, dt=self.dt, commands=state.commands,
            base_pos=phys.base_pos, base_quat=phys.base_quat,
            base_lin_vel=qops.quat_rotate_inverse(phys.base_quat,
                                                  phys.base_lin_vel),
            base_ang_vel=qops.quat_rotate_inverse(phys.base_quat,
                                                  phys.base_ang_vel),
            projected_gravity=qops.quat_rotate_inverse(phys.base_quat,
                                                       gravity_vec),
            gravity_vec=gravity_vec,
            dof_pos=phys.q, default_dof_pos=self.default_dof_pos,
            dof_vel=phys.qd, last_dof_vel=state.last_dof_vel,
            torques=state.torques, actions=state.actions,
            last_actions=state.last_actions,
            last_last_actions=state.last_last_actions,
            joint_pos_target=state.joint_pos_target,
            last_joint_pos_target=state.last_joint_pos_target,
            last_last_joint_pos_target=state.last_last_joint_pos_target,
            contact_forces=state.contact_forces,
            foot_velocities=state.foot_velocities,
            prev_foot_velocities=state.prev_foot_velocities,
            foot_positions=state.foot_positions,
            desired_contact_states=state.desired_contact_states,
            foot_indices=state.foot_indices,
            last_contacts=state.last_contacts,
            dof_pos_limits=self.dof_pos_limits,
            feet_indices=self._feet_idx,
            penalised_indices=self._penalised_idx,
        )

    def _compute_reward(self, ctx, state, base_lin_vel_b, base_ang_vel_b):
        cfg = self.cfg
        N = self.num_envs
        dev = self.device
        rew_total = torch.zeros(N, device=dev)
        zero = torch.zeros(N, device=dev)
        cmd_key_idx = {k: i for i, k in enumerate(COMMAND_SUM_KEYS)}
        ep_cols = []
        cmd_cols = [zero] * len(COMMAND_SUM_KEYS)
        for i, name in enumerate(self.reward_names):
            r = rew_mod.TERMS[name](ctx) * self.reward_scales[i]
            rew_total = rew_total + r
            ep_cols.append(r)
            if name in cmd_key_idx:
                j = cmd_key_idx[name]
                if name in ("tracking_contacts_shaped_force",
                            "tracking_contacts_shaped_vel"):
                    # legged_robot.py:280-281: scale + rew (positive-shifted)
                    cmd_cols[j] = self.reward_scales[i] + r
                else:
                    cmd_cols[j] = r
        if cfg.rewards.only_positive_rewards:
            rew_total = torch.clamp(rew_total, min=0.0)
        elif cfg.rewards.only_positive_rewards_ji22_style:
            # a term counts as positive or negative by the sign of its sum
            # over the whole batch (every rank's envs)
            sums = self.rows.all_reduce_sum(
                [torch.stack([torch.sum(r) for r in ep_cols])])[0]
            rew_pos = torch.zeros(N, device=dev)
            rew_neg = torch.zeros(N, device=dev)
            for i, r in enumerate(ep_cols):
                rew_pos = rew_pos + torch.where(sums[i] >= 0, r, zero)
                rew_neg = rew_neg + torch.where(sums[i] < 0, r, zero)
            rew_total = rew_pos * torch.exp(rew_neg / cfg.rewards.sigma_rew_neg)
        ep_cols.append(rew_total)
        ep_sums = state.episode_sums + torch.stack(ep_cols, dim=1)
        ki = cmd_key_idx
        cmd_cols[ki["lin_vel_raw"]] = base_lin_vel_b[:, 0]
        cmd_cols[ki["ang_vel_raw"]] = base_ang_vel_b[:, 2]
        cmd_cols[ki["lin_vel_residual"]] = torch.square(
            base_lin_vel_b[:, 0] - state.commands[:, 0])
        cmd_cols[ki["ang_vel_residual"]] = torch.square(
            base_ang_vel_b[:, 2] - state.commands[:, 2])
        cmd_cols[ki["ep_timesteps"]] = torch.ones(N, device=dev)
        cmd_sums = state.command_sums + torch.stack(cmd_cols, dim=1)
        return rew_total, ep_sums, cmd_sums

    # -- curriculum + command resampling -----------------------------------
    def _resample_commands(self, state: EnvState, mask, gen):
        """Masked _resample_commands (legged_robot.py:710-824).  With an
        eval commands cfg of its own, each slice updates and samples its
        own curriculum, the train slice first (reference _call_train_eval,
        legged_robot.py:531-544).

        Note the reference samples from the curricula unconditionally — the
        command_curriculum flag only gates extras logging."""
        K = len(curr.TASK_KEYS)
        lim = self.max_episode_length
        rows = self.rows
        T = rows.num_train
        # (global rows of the split, this rank's rows of a draw over them)
        if self.eval_commands_differ:
            whole = [(slice(0, T), rows.take_train),
                     (slice(T, None), rows.take_eval)]
        else:
            whole = [(slice(None), rows.take)]
        splits = [(whole[0], state.curriculum, self.curr_grid,
                   self._curr_consts, self.cfg.commands,
                   min(lim, self.resample_interval))]
        if self.eval_commands_differ:
            ev = self.eval_cfg.commands
            splits.append((whole[1], state.curriculum_eval,
                           self.curr_grid_eval, self._curr_consts_eval, ev,
                           min(lim, int(ev.resampling_time / self.dt))))
        # the curriculum scores every env of the batch: the ranks' rows
        # gathered first (one collective)
        g_mask, g_bins, g_cats, g_sums = rows.gather(
            [mask, state.env_command_bins, state.env_command_categories,
             state.command_sums[:, :K]])
        curs, parts = [], []
        for (sl, _), cur, grid, (adjacency, _, _), _, ep_len in splits:
            curs.append(curr.update(
                cur, grid, g_mask[sl], g_bins[sl], g_cats[sl],
                g_sums[sl] / ep_len, self.task_thresholds,
                adjacency=adjacency))
        for ((sl, keep), _, grid, (_, centroids, bin_sizes), cmd_cfg, _), \
                cur in zip(splits, curs):
            n = g_mask[sl].shape[0]
            cmds, bins, cats = curr.sample(cur, grid, gen, n, keep,
                                           centroids, bin_sizes)
            parts.append((curr.postprocess_gaitwise(cmds, cats, cmd_cfg),
                          bins, cats))
        new_cmds, new_bins, new_cats = (torch.cat(x) for x in zip(*parts))
        commands = torch.where(mask[:, None], new_cmds[:, :15], state.commands)
        bins = torch.where(mask, new_bins, state.env_command_bins)
        cats = torch.where(mask, new_cats, state.env_command_categories)
        # reset command sums for resampled envs (legged_robot.py:822-824)
        cmd_sums = torch.where(mask[:, None],
                               torch.zeros((), device=self.device),
                               state.command_sums)
        return state._replace(curriculum=curs[0],
                              curriculum_eval=(curs[1] if len(curs) > 1
                                               else state.curriculum_eval),
                              commands=commands,
                              env_command_bins=bins,
                              env_command_categories=cats,
                              command_sums=cmd_sums)

    def _apply_dof_props_mask(self, state: EnvState, mask, gen):
        ms, mo, kp, kd = self._sample_dof_props(gen, self.num_envs)
        mm = mask[:, None]
        return state._replace(
            motor_strengths=torch.where(mm, ms, state.motor_strengths),
            motor_offsets=torch.where(mm, mo, state.motor_offsets),
            Kp_factors=torch.where(mm, kp, state.Kp_factors),
            Kd_factors=torch.where(mm, kd, state.Kd_factors),
        )

    def _teleport(self, phys: engine.PhysicsState) -> engine.PhysicsState:
        """Edge teleport (legged_robot.py:1028-1051)."""
        tc = self.cfg.terrain
        thresh = tc.teleport_thresh
        span_x = tc.terrain_length * (tc.num_rows - 1)
        span_y = tc.terrain_width * (tc.num_cols - 1)
        x, y = phys.base_pos[:, 0], phys.base_pos[:, 1]
        x = torch.where(x < thresh, x + span_x, x)
        x = torch.where(x > tc.terrain_length * tc.num_rows - thresh, x - span_x, x)
        y = torch.where(y < thresh, y + span_y, y)
        y = torch.where(y > tc.terrain_width * tc.num_cols - thresh, y - span_y, y)
        return phys._replace(
            base_pos=torch.stack([x, y, phys.base_pos[:, 2]], dim=-1))

    def _reset_envs(self, state: EnvState, reset_mask, gen):
        """Masked reset_idx (legged_robot.py:150-239)."""
        mask = reset_mask
        mm = mask[:, None]
        zf = torch.zeros((), device=self.device)
        cand = self._sample_reset_state(state, gen)
        phys = engine.PhysicsState(
            base_pos=torch.where(mm, cand.base_pos, state.phys.base_pos),
            base_quat=torch.where(mm, cand.base_quat, state.phys.base_quat),
            base_lin_vel=torch.where(mm, cand.base_lin_vel, state.phys.base_lin_vel),
            base_ang_vel=torch.where(mm, cand.base_ang_vel, state.phys.base_ang_vel),
            q=torch.where(mm, cand.q, state.phys.q),
            qd=torch.where(mm, cand.qd, state.phys.qd),
        )
        state = state._replace(phys=phys)
        # resample commands for reset envs (also updates curriculum with the
        # terminated episodes' stats)
        state = self._resample_commands(state, mask, gen)
        # dof-prop DR on reset (legged_robot.py:165)
        state = self._apply_dof_props_mask(state, mask, gen)
        # cross-step contact warm-start seeds are stale for reset envs:
        # zero them (env-minor layout, pad the mask to Npad)
        Npad = state.contact_lam_t.shape[-1]
        keep_t = torch.nn.functional.pad(
            1.0 - mask.to(state.contact_lam_t.dtype),
            (0, Npad - mask.shape[0]))
        return state._replace(
            last_actions=torch.where(mm, zf, state.last_actions),
            last_last_actions=torch.where(mm, zf, state.last_last_actions),
            last_dof_vel=torch.where(mm, zf, state.last_dof_vel),
            episode_length=torch.where(
                mask, torch.zeros_like(state.episode_length),
                state.episode_length),
            gait_indices=torch.where(mask, zf, state.gait_indices),
            lag_buffer=torch.where(mask[:, None, None], zf, state.lag_buffer),
            episode_sums=torch.where(mm, zf, state.episode_sums),
            contact_lam_t=state.contact_lam_t * keep_t,
        )

    # -- public reset ------------------------------------------------------
    def reset(self, rng: "torch.Generator | int" = 0,
              random_episode_lengths: bool = False):
        """Full reset: fresh state, all envs reset, one zero-action step
        (reference BaseTask.reset, base_task.py:98-103).  `rng` is a
        generator on the env's device, or a seed for one."""
        gen = rng if isinstance(rng, torch.Generator) \
            else make_generator(rng, self.device)
        state = self.init_state(gen)
        state = self._reset_envs(
            state, torch.ones(self.num_envs, dtype=torch.bool,
                              device=self.device), gen)
        if random_episode_lengths:
            state = state._replace(episode_length=self.rows.take(
                torch.randint(0, self.max_episode_length,
                              (self.num_envs_global,), generator=gen,
                              device=self.device, dtype=torch.int32)))
        state, obs_dict, _, _, _ = self.step(
            state, torch.zeros((self.num_envs, self.num_actions),
                               device=self.device))
        return state, obs_dict
