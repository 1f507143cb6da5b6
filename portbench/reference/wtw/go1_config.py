"""Frozen copy of walk_these_ways_tpu_torch/go1_config.py, the plain half of the benchmark's
reference (portbench/reference/__init__.py): it imports nothing of the package
it was copied from, and runs no kernel.

Go1 config presets.

``go1_cfg()`` mirrors reference go1_gym/envs/go1/go1_config.py:8-106;
``mob_train_cfg()`` layers on the Multiplicity-of-Behavior training overrides
from reference scripts/train.py:21-205 (the full 15-command gait-conditioned
setup with actuator net, lag, DR, and the CoRL reward set).
"""
from __future__ import annotations

from dataclasses import replace

from .config import Cfg, ControlCfg, CurriculumThresholds, InitStateCfg

GO1_DEFAULT_JOINT_ANGLES = (
    ("FL_hip_joint", 0.1), ("RL_hip_joint", 0.1),
    ("FR_hip_joint", -0.1), ("RR_hip_joint", -0.1),
    ("FL_thigh_joint", 0.8), ("RL_thigh_joint", 1.0),
    ("FR_thigh_joint", 0.8), ("RR_thigh_joint", 1.0),
    ("FL_calf_joint", -1.5), ("RL_calf_joint", -1.5),
    ("FR_calf_joint", -1.5), ("RR_calf_joint", -1.5),
)


def go1_cfg() -> Cfg:
    cfg = Cfg()
    cfg = replace(
        cfg,
        init_state=InitStateCfg(
            pos=(0.0, 0.0, 0.34),
            default_joint_angles=GO1_DEFAULT_JOINT_ANGLES,
        ),
        control=ControlCfg(
            control_type="P",
            stiffness=(("joint", 20.0),),
            damping=(("joint", 0.5),),
            action_scale=0.25,
            hip_scale_reduction=0.5,
            decimation=4,
        ),
        rewards=replace(
            cfg.rewards, soft_dof_pos_limit=0.9, base_height_target=0.34
        ),
        reward_scales=replace(
            cfg.reward_scales,
            torques=-0.0001, action_rate=-0.01, dof_pos_limits=-10.0,
            orientation=-5.0, base_height=-30.0,
        ),
        terrain=replace(
            cfg.terrain,
            mesh_type="trimesh", measure_heights=False,
            terrain_noise_magnitude=0.0, teleport_robots=True,
            border_size=50.0,
            terrain_proportions=(0, 0, 0, 0, 0, 0, 0, 0, 1.0),
            curriculum=False,
        ),
        env=replace(
            cfg.env, num_observations=42, observe_vel=False, num_envs=4000
        ),
        commands=replace(
            cfg.commands,
            heading_command=False, resampling_time=10.0,
            command_curriculum=True,
            lin_vel_x=(-0.6, 0.6), lin_vel_y=(-0.6, 0.6), ang_vel_yaw=(-1.0, 1.0),
        ),
        domain_rand=replace(
            cfg.domain_rand,
            randomize_base_mass=True, added_mass_range=(-1.0, 3.0),
            push_robots=False, max_push_vel_xy=0.5,
            randomize_friction=True, friction_range=(0.05, 4.5),
            randomize_restitution=True, restitution_range=(0.0, 1.0),
            randomize_com_displacement=True, com_displacement_range=(-0.1, 0.1),
            randomize_motor_strength=True, motor_strength_range=(0.9, 1.1),
            randomize_Kp_factor=False, randomize_Kd_factor=False,
            rand_interval_s=6.0,
        ),
    )
    return cfg


def mob_train_cfg(num_envs: int = 4000) -> Cfg:
    """The full walk-these-ways training config (reference scripts/train.py).

    Uses matrix-reuse across decimation substeps and the one-launch
    control-step kernel.
    """
    cfg = go1_cfg()
    from .config import SimCfg
    cfg = replace(
        cfg,
        # matrix reuse + the env-minor control-step kernel
        sim=replace(cfg.sim, reuse_matrices=True, use_pallas_contact=True),
        curriculum_thresholds=CurriculumThresholds(
            tracking_lin_vel=0.8, tracking_ang_vel=0.7,
            tracking_contacts_shaped_vel=0.90, tracking_contacts_shaped_force=0.90,
        ),
        control=replace(cfg.control, control_type="actuator_net"),
        domain_rand=replace(
            cfg.domain_rand,
            lag_timesteps=6, randomize_lag_timesteps=True,
            randomize_rigids_after_start=False,
            randomize_friction=True, friction_range=(0.1, 3.0),
            randomize_restitution=True, restitution_range=(0.0, 0.4),
            randomize_base_mass=True, added_mass_range=(-1.0, 3.0),
            randomize_gravity=True, gravity_range=(-1.0, 1.0),
            gravity_rand_interval_s=8.0, gravity_impulse_duration=0.99,
            randomize_com_displacement=False, com_displacement_range=(-0.15, 0.15),
            randomize_motor_strength=True, motor_strength_range=(0.9, 1.1),
            randomize_motor_offset=True, motor_offset_range=(-0.02, 0.02),
            push_robots=False,
            randomize_Kp_factor=False, randomize_Kd_factor=False,
            rand_interval_s=4.0,
        ),
        env=replace(
            cfg.env,
            num_envs=num_envs,
            num_privileged_obs=2,
            num_observation_history=30,
            num_observations=70,
            num_scalar_observations=70,
            observe_two_prev_actions=True,
            observe_yaw=False,
            observe_gait_commands=True,
            observe_timing_parameter=False,
            observe_clock_inputs=True,
            priv_observe_friction=True,
            priv_observe_restitution=True,
            priv_observe_base_mass=False,
            priv_observe_gravity=False,
            priv_observe_com_displacement=False,
            priv_observe_motor_strength=False,
            priv_observe_motor_offset=False,
        ),
        terrain=replace(
            cfg.terrain,
            border_size=0.0, mesh_type="trimesh",
            num_cols=30, num_rows=30,
            terrain_width=5.0, terrain_length=5.0,
            x_init_range=0.2, y_init_range=0.2,
            teleport_thresh=0.3, teleport_robots=False,
            center_robots=True, center_span=4,
            horizontal_scale=0.10,
            yaw_init_range=3.14,
        ),
        rewards=replace(
            cfg.rewards,
            use_terminal_body_height=True, terminal_body_height=0.05,
            use_terminal_roll_pitch=True, terminal_body_ori=1.6,
            base_height_target=0.30,
            kappa_gait_probs=0.07, gait_force_sigma=100.0, gait_vel_sigma=10.0,
            only_positive_rewards=False,
            only_positive_rewards_ji22_style=True,
            sigma_rew_neg=0.02,
        ),
        reward_scales=replace(
            cfg.reward_scales,
            feet_contact_forces=0.0,
            feet_slip=-0.04,
            action_smoothness_1=-0.1,
            action_smoothness_2=-0.1,
            dof_vel=-1e-4,
            dof_pos=-0.0,
            jump=10.0,
            base_height=0.0,
            raibert_heuristic=-10.0,
            feet_impact_vel=-0.0,
            feet_clearance_cmd_linear=-30.0,
            orientation=0.0,
            orientation_control=-5.0,
            lin_vel_z=-0.02,
            ang_vel_xy=-0.001,
            feet_air_time=0.0,
            tracking_contacts_shaped_force=4.0,
            tracking_contacts_shaped_vel=4.0,
            collision=-5.0,
        ),
        commands=replace(
            cfg.commands,
            num_commands=15,
            resampling_time=10.0,
            lin_vel_x=(-1.0, 1.0), lin_vel_y=(-0.6, 0.6), ang_vel_yaw=(-1.0, 1.0),
            body_height_cmd=(-0.25, 0.15),
            gait_frequency_cmd_range=(2.0, 4.0),
            gait_phase_cmd_range=(0.0, 1.0),
            gait_offset_cmd_range=(0.0, 1.0),
            gait_bound_cmd_range=(0.0, 1.0),
            gait_duration_cmd_range=(0.5, 0.5),
            footswing_height_range=(0.03, 0.35),
            body_pitch_range=(-0.4, 0.4),
            body_roll_range=(-0.0, 0.0),
            stance_width_range=(0.10, 0.45),
            stance_length_range=(0.35, 0.45),
            limit_vel_x=(-5.0, 5.0), limit_vel_y=(-0.6, 0.6),
            limit_vel_yaw=(-5.0, 5.0),
            limit_body_height=(-0.25, 0.15),
            limit_gait_frequency=(2.0, 4.0),
            limit_gait_phase=(0.0, 1.0), limit_gait_offset=(0.0, 1.0),
            limit_gait_bound=(0.0, 1.0), limit_gait_duration=(0.5, 0.5),
            limit_footswing_height=(0.03, 0.35),
            limit_body_pitch=(-0.4, 0.4), limit_body_roll=(-0.0, 0.0),
            limit_stance_width=(0.10, 0.45), limit_stance_length=(0.35, 0.45),
            num_bins_vel_x=21, num_bins_vel_y=1, num_bins_vel_yaw=21,
            num_bins_body_height=1, num_bins_gait_frequency=1,
            num_bins_gait_phase=1, num_bins_gait_offset=1,
            num_bins_gait_bound=1, num_bins_gait_duration=1,
            num_bins_footswing_height=1, num_bins_body_roll=1,
            num_bins_body_pitch=1, num_bins_stance_width=1,
            num_bins_stance_length=1, num_bins_aux_reward_coef=1,
            exclusive_phase_offset=False, pacing_offset=False,
            binary_phases=True, gaitwise_curricula=True,
        ),
        normalization=replace(
            cfg.normalization,
            friction_range=(0.0, 1.0),
            ground_friction_range=(0.0, 1.0),
            clip_actions=10.0,
        ),
    )
    return cfg
