"""Frozen copy of walk_these_ways_tpu_torch/config.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Frozen, hashable config tree.

Counterpart of the reference's params_proto ``Cfg`` class tree
(reference: go1_gym/envs/base/legged_robot_config.py:6-422).  Same sections
and field names so reference configs translate mechanically, but immutable
dataclasses: a config instance is hashable and can be compared field by
field.  This is the PyTorch port's own copy of the JAX package's config.py,
kept field for field (tests/test_torch_config.py holds the two equal).

Lists become tuples; the ``default_joint_angles``/``stiffness``/``damping``
dicts become tuples of (name, value) pairs.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


def _t(*vals):
    return tuple(vals)


@dataclass(frozen=True)
class EnvCfg:
    num_envs: int = 4096
    num_observations: int = 235
    num_scalar_observations: int = 42
    num_privileged_obs: int = 18
    num_actions: int = 12
    num_observation_history: int = 15
    episode_length_s: float = 20.0
    observe_vel: bool = True
    observe_only_ang_vel: bool = False
    observe_only_lin_vel: bool = False
    observe_yaw: bool = False
    observe_contact_states: bool = False
    observe_command: bool = True
    observe_gait_commands: bool = False
    observe_timing_parameter: bool = False
    observe_clock_inputs: bool = False
    observe_two_prev_actions: bool = False
    priv_observe_friction: bool = True
    priv_observe_restitution: bool = True
    priv_observe_base_mass: bool = True
    priv_observe_com_displacement: bool = True
    priv_observe_motor_strength: bool = False
    priv_observe_motor_offset: bool = False
    priv_observe_body_velocity: bool = False
    priv_observe_body_height: bool = False
    priv_observe_gravity: bool = False
    priv_observe_clock_inputs: bool = False
    priv_observe_desired_contact_states: bool = False


@dataclass(frozen=True)
class TerrainCfg:
    mesh_type: str = "trimesh"         # none / plane / heightfield / trimesh
    horizontal_scale: float = 0.1
    vertical_scale: float = 0.005
    border_size: float = 0.0
    curriculum: bool = True
    static_friction: float = 1.0
    dynamic_friction: float = 1.0
    restitution: float = 0.0
    terrain_noise_magnitude: float = 0.1
    terrain_smoothness: float = 0.005
    measure_heights: bool = True
    measured_points_x: Tuple[float, ...] = _t(
        -0.8, -0.7, -0.6, -0.5, -0.4, -0.3, -0.2, -0.1, 0.0,
        0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8)
    measured_points_y: Tuple[float, ...] = _t(
        -0.5, -0.4, -0.3, -0.2, -0.1, 0.0, 0.1, 0.2, 0.3, 0.4, 0.5)
    min_init_terrain_level: int = 0
    max_init_terrain_level: int = 5
    terrain_length: float = 8.0
    terrain_width: float = 8.0
    num_rows: int = 10
    num_cols: int = 20
    terrain_proportions: Tuple[float, ...] = _t(0.1, 0.1, 0.35, 0.25, 0.2)
    slope_treshold: float = 0.75
    difficulty_scale: float = 1.0
    x_init_range: float = 1.0
    y_init_range: float = 1.0
    yaw_init_range: float = 0.0
    x_init_offset: float = 0.0
    y_init_offset: float = 0.0
    teleport_robots: bool = True
    teleport_thresh: float = 2.0
    max_platform_height: float = 0.2
    center_robots: bool = False
    center_span: int = 5


@dataclass(frozen=True)
class CommandsCfg:
    command_curriculum: bool = False
    num_commands: int = 3
    resampling_time: float = 10.0
    curriculum_seed: int = 100
    lin_vel_x: Tuple[float, float] = (-1.0, 1.0)
    lin_vel_y: Tuple[float, float] = (-1.0, 1.0)
    ang_vel_yaw: Tuple[float, float] = (-1.0, 1.0)
    body_height_cmd: Tuple[float, float] = (-0.05, 0.05)
    gait_frequency_cmd_range: Tuple[float, float] = (2.0, 2.01)
    gait_phase_cmd_range: Tuple[float, float] = (0.0, 0.01)
    gait_offset_cmd_range: Tuple[float, float] = (0.0, 0.01)
    gait_bound_cmd_range: Tuple[float, float] = (0.0, 0.01)
    gait_duration_cmd_range: Tuple[float, float] = (0.49, 0.5)
    footswing_height_range: Tuple[float, float] = (0.06, 0.061)
    body_pitch_range: Tuple[float, float] = (0.0, 0.01)
    body_roll_range: Tuple[float, float] = (0.0, 0.01)
    stance_width_range: Tuple[float, float] = (0.0, 0.01)
    stance_length_range: Tuple[float, float] = (0.0, 0.01)
    aux_reward_coef_range: Tuple[float, float] = (0.0, 0.01)
    limit_vel_x: Tuple[float, float] = (-10.0, 10.0)
    limit_vel_y: Tuple[float, float] = (-0.6, 0.6)
    limit_vel_yaw: Tuple[float, float] = (-10.0, 10.0)
    limit_body_height: Tuple[float, float] = (-0.05, 0.05)
    limit_gait_frequency: Tuple[float, float] = (2.0, 2.01)
    limit_gait_phase: Tuple[float, float] = (0.0, 0.01)
    limit_gait_offset: Tuple[float, float] = (0.0, 0.01)
    limit_gait_bound: Tuple[float, float] = (0.0, 0.01)
    limit_gait_duration: Tuple[float, float] = (0.49, 0.5)
    limit_footswing_height: Tuple[float, float] = (0.06, 0.061)
    limit_body_pitch: Tuple[float, float] = (0.0, 0.01)
    limit_body_roll: Tuple[float, float] = (0.0, 0.01)
    limit_stance_width: Tuple[float, float] = (0.0, 0.01)
    limit_stance_length: Tuple[float, float] = (0.0, 0.01)
    limit_aux_reward_coef: Tuple[float, float] = (0.0, 0.01)
    num_bins_vel_x: int = 25
    num_bins_vel_y: int = 3
    num_bins_vel_yaw: int = 25
    num_bins_body_height: int = 1
    num_bins_gait_frequency: int = 11
    num_bins_gait_phase: int = 11
    num_bins_gait_offset: int = 2
    num_bins_gait_bound: int = 2
    num_bins_gait_duration: int = 3
    num_bins_footswing_height: int = 1
    num_bins_body_pitch: int = 1
    num_bins_body_roll: int = 1
    num_bins_stance_width: int = 1
    num_bins_stance_length: int = 1
    num_bins_aux_reward_coef: int = 1
    heading_command: bool = True
    exclusive_phase_offset: bool = True
    binary_phases: bool = False
    pacing_offset: bool = False
    balance_gait_distribution: bool = True
    gaitwise_curricula: bool = True

    @property
    def bin_counts(self) -> Tuple[int, ...]:
        return (
            self.num_bins_vel_x, self.num_bins_vel_y, self.num_bins_vel_yaw,
            self.num_bins_body_height, self.num_bins_gait_frequency,
            self.num_bins_gait_phase, self.num_bins_gait_offset,
            self.num_bins_gait_bound, self.num_bins_gait_duration,
            self.num_bins_footswing_height, self.num_bins_body_pitch,
            self.num_bins_body_roll, self.num_bins_stance_width,
            self.num_bins_stance_length, self.num_bins_aux_reward_coef,
        )

    @property
    def limits_low(self) -> Tuple[float, ...]:
        return tuple(r[0] for r in self._limit_ranges())

    @property
    def limits_high(self) -> Tuple[float, ...]:
        return tuple(r[1] for r in self._limit_ranges())

    def _limit_ranges(self):
        return (
            self.limit_vel_x, self.limit_vel_y, self.limit_vel_yaw,
            self.limit_body_height, self.limit_gait_frequency,
            self.limit_gait_phase, self.limit_gait_offset,
            self.limit_gait_bound, self.limit_gait_duration,
            self.limit_footswing_height, self.limit_body_pitch,
            self.limit_body_roll, self.limit_stance_width,
            self.limit_stance_length, self.limit_aux_reward_coef,
        )

    @property
    def ranges_low(self) -> Tuple[float, ...]:
        return tuple(r[0] for r in self._cmd_ranges())

    @property
    def ranges_high(self) -> Tuple[float, ...]:
        return tuple(r[1] for r in self._cmd_ranges())

    def _cmd_ranges(self):
        return (
            self.lin_vel_x, self.lin_vel_y, self.ang_vel_yaw,
            self.body_height_cmd, self.gait_frequency_cmd_range,
            self.gait_phase_cmd_range, self.gait_offset_cmd_range,
            self.gait_bound_cmd_range, self.gait_duration_cmd_range,
            self.footswing_height_range, self.body_pitch_range,
            self.body_roll_range, self.stance_width_range,
            self.stance_length_range, self.aux_reward_coef_range,
        )


@dataclass(frozen=True)
class CurriculumThresholds:
    tracking_lin_vel: float = 0.8
    tracking_ang_vel: float = 0.5
    tracking_contacts_shaped_force: float = 0.8
    tracking_contacts_shaped_vel: float = 0.8


@dataclass(frozen=True)
class InitStateCfg:
    pos: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    rot: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    lin_vel: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    ang_vel: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    default_joint_angles: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class ControlCfg:
    control_type: str = "actuator_net"   # 'P' or 'actuator_net'
    stiffness: Tuple[Tuple[str, float], ...] = (("joint", 20.0),)
    damping: Tuple[Tuple[str, float], ...] = (("joint", 0.5),)
    action_scale: float = 0.5
    hip_scale_reduction: float = 1.0
    decimation: int = 4


@dataclass(frozen=True)
class DomainRandCfg:
    rand_interval_s: float = 10.0
    randomize_rigids_after_start: bool = True
    randomize_friction: bool = True
    friction_range: Tuple[float, float] = (0.5, 1.25)
    randomize_restitution: bool = False
    restitution_range: Tuple[float, float] = (0.0, 1.0)
    randomize_base_mass: bool = False
    added_mass_range: Tuple[float, float] = (-1.0, 1.0)
    randomize_com_displacement: bool = False
    com_displacement_range: Tuple[float, float] = (-0.15, 0.15)
    randomize_motor_strength: bool = False
    motor_strength_range: Tuple[float, float] = (0.9, 1.1)
    randomize_motor_offset: bool = False
    motor_offset_range: Tuple[float, float] = (-0.05, 0.05)
    randomize_Kp_factor: bool = False
    Kp_factor_range: Tuple[float, float] = (0.8, 1.3)
    randomize_Kd_factor: bool = False
    Kd_factor_range: Tuple[float, float] = (0.5, 1.5)
    gravity_rand_interval_s: float = 7.0
    gravity_impulse_duration: float = 1.0
    randomize_gravity: bool = False
    gravity_range: Tuple[float, float] = (-1.0, 1.0)
    push_robots: bool = True
    push_interval_s: float = 15.0
    max_push_vel_xy: float = 1.0
    randomize_lag_timesteps: bool = True
    lag_timesteps: int = 6


@dataclass(frozen=True)
class RewardsCfg:
    only_positive_rewards: bool = True
    only_positive_rewards_ji22_style: bool = False
    sigma_rew_neg: float = 5.0
    tracking_sigma: float = 0.25
    tracking_sigma_yaw: float = 0.25
    soft_dof_pos_limit: float = 1.0
    base_height_target: float = 1.0
    max_contact_force: float = 100.0
    use_terminal_body_height: bool = False
    terminal_body_height: float = 0.20
    use_terminal_roll_pitch: bool = False
    terminal_body_ori: float = 0.5
    kappa_gait_probs: float = 0.07
    gait_force_sigma: float = 50.0
    gait_vel_sigma: float = 0.5


@dataclass(frozen=True)
class RewardScalesCfg:
    """Reward term weights (reference legged_robot_config.py:297-332 +
    scripts/train.py overrides). Zero scale disables the term entirely."""
    termination: float = -0.0
    tracking_lin_vel: float = 1.0
    tracking_ang_vel: float = 0.5
    lin_vel_z: float = -2.0
    ang_vel_xy: float = -0.05
    orientation: float = -0.0
    orientation_control: float = 0.0
    torques: float = -0.00001
    dof_vel: float = -0.0
    dof_acc: float = -2.5e-7
    dof_pos: float = 0.0
    base_height: float = -0.0
    collision: float = -1.0
    action_rate: float = -0.01
    tracking_contacts_shaped_force: float = 0.0
    tracking_contacts_shaped_vel: float = 0.0
    jump: float = 0.0
    dof_pos_limits: float = 0.0
    feet_contact_forces: float = 0.0
    feet_slip: float = 0.0
    feet_clearance_cmd_linear: float = 0.0
    action_smoothness_1: float = 0.0
    action_smoothness_2: float = 0.0
    feet_impact_vel: float = 0.0
    raibert_heuristic: float = 0.0
    feet_air_time: float = 0.0
    estimation_bonus: float = 0.0

    def items(self):
        return dataclasses.asdict(self).items()


@dataclass(frozen=True)
class NormalizationCfg:
    clip_observations: float = 100.0
    clip_actions: float = 100.0
    friction_range: Tuple[float, float] = (0.05, 4.5)
    ground_friction_range: Tuple[float, float] = (0.05, 4.5)
    restitution_range: Tuple[float, float] = (0.0, 1.0)
    added_mass_range: Tuple[float, float] = (-1.0, 3.0)
    com_displacement_range: Tuple[float, float] = (-0.1, 0.1)
    motor_strength_range: Tuple[float, float] = (0.9, 1.1)
    motor_offset_range: Tuple[float, float] = (-0.05, 0.05)
    body_velocity_range: Tuple[float, float] = (-6.0, 6.0)
    body_height_range: Tuple[float, float] = (0.0, 0.60)
    gravity_range: Tuple[float, float] = (-1.0, 1.0)


@dataclass(frozen=True)
class ObsScalesCfg:
    lin_vel: float = 2.0
    ang_vel: float = 0.25
    dof_pos: float = 1.0
    dof_vel: float = 0.05
    body_height_cmd: float = 2.0
    gait_phase_cmd: float = 1.0
    gait_freq_cmd: float = 1.0
    footswing_height_cmd: float = 0.15
    body_pitch_cmd: float = 0.3
    body_roll_cmd: float = 0.3
    aux_reward_cmd: float = 1.0
    stance_width_cmd: float = 1.0
    stance_length_cmd: float = 1.0


@dataclass(frozen=True)
class NoiseCfg:
    add_noise: bool = True
    noise_level: float = 1.0


@dataclass(frozen=True)
class NoiseScalesCfg:
    dof_pos: float = 0.01
    dof_vel: float = 1.5
    lin_vel: float = 0.1
    ang_vel: float = 0.2
    gravity: float = 0.05
    contact_states: float = 0.05


@dataclass(frozen=True)
class SimCfg:
    dt: float = 0.005
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    num_contact_iters: int = 16
    # reuse mass matrix / contact factorizations across the decimation
    # substeps of one control step (speed knob; ~cm-scale geometric lag)
    reuse_matrices: bool = False
    # env-minor kernel contact pipeline — requires reuse_matrices.  The
    # field keeps the JAX package's name so the two config trees stay
    # equal; in this package it selects the hand-written control-step
    # kernel (ops/megastep.py).
    use_pallas_contact: bool = False
    # fold the whole control step (torque model + all decimation substeps +
    # integration) into one kernel launch (ops/megastep.py); only takes
    # effect with use_pallas_contact + reuse_matrices
    megastep: bool = True
    # warm-start the contact impulses: substeps after the first start the
    # projected-Jacobi iteration from the previous substep's converged
    # impulses (as PhysX does) and run num_contact_iters_warm iterations
    # instead of num_contact_iters.  Only takes effect on the megastep
    # path; exact mode (reuse_matrices=False) always cold-starts.
    contact_warm_start: bool = True
    # 3 warm iterations/substep (12 total per control step with the
    # cross-step seed)
    num_contact_iters_warm: int = 3
    # additionally carry the converged impulses across control steps in
    # EnvState (zeroed on reset) and warm-start the FIRST substep from
    # them at the warm iteration count — all 4 substeps then run
    # num_contact_iters_warm iterations.
    contact_cross_step_warm_start: bool = True


@dataclass(frozen=True)
class Cfg:
    env: EnvCfg = field(default_factory=EnvCfg)
    terrain: TerrainCfg = field(default_factory=TerrainCfg)
    commands: CommandsCfg = field(default_factory=CommandsCfg)
    curriculum_thresholds: CurriculumThresholds = field(default_factory=CurriculumThresholds)
    init_state: InitStateCfg = field(default_factory=InitStateCfg)
    control: ControlCfg = field(default_factory=ControlCfg)
    domain_rand: DomainRandCfg = field(default_factory=DomainRandCfg)
    rewards: RewardsCfg = field(default_factory=RewardsCfg)
    reward_scales: RewardScalesCfg = field(default_factory=RewardScalesCfg)
    normalization: NormalizationCfg = field(default_factory=NormalizationCfg)
    obs_scales: ObsScalesCfg = field(default_factory=ObsScalesCfg)
    noise: NoiseCfg = field(default_factory=NoiseCfg)
    noise_scales: NoiseScalesCfg = field(default_factory=NoiseScalesCfg)
    sim: SimCfg = field(default_factory=SimCfg)

    # derived quantities ---------------------------------------------------
    @property
    def dt(self) -> float:
        """Control dt = decimation * sim dt (reference legged_robot.py:1717)."""
        return self.control.decimation * self.sim.dt

    @property
    def max_episode_length(self) -> int:
        import math
        return int(math.ceil(self.env.episode_length_s / self.dt))
