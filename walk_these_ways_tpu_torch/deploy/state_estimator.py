"""Robot-side state estimator (Python half of the deployment stack).

Rebuild of the reference StateEstimator (reference:
go1_gym_deploy/utils/cheetah_state_estimator.py:51-406): subscribes to the
bridge's channels, remaps SDK joint order to sim order
(``joint_idxs=[3,4,5,0,1,2,9,10,11,6,7,8]``, :55), smooths body angular
velocity over a 12-sample window (:70-77,140-142), estimates contacts from
foot force > 200 N (:281), and maps the RC joystick to the 15-dim command
vector with mode cycling (:148-221).
"""
from __future__ import annotations

import time

import numpy as np

from . import messages as msg
from .bus import Bus


def rotation_from_rpy(rpy):
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), \
        np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    return Rz @ Ry @ Rx


class StateEstimator:
    # SDK (FR,FL,RR,RL) -> sim (FL,FR,RL,RR) joint remap (reference :55)
    JOINT_IDXS = [3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8]
    CONTACT_IDXS = [1, 0, 3, 2]

    def __init__(self, bus: Bus, use_cameras: bool = False):
        self.bus = bus
        self.joint_pos = np.zeros(12)
        self.joint_vel = np.zeros(12)
        self.tau_est = np.zeros(12)
        self.euler = np.zeros(3)
        self.euler_prev = np.zeros(3)
        self.R = np.eye(3)
        self.world_lin_vel = np.zeros(3)
        self.contact_state = np.ones(4)
        self.body_loc = np.zeros(3)
        self.body_quat = np.array([0.0, 0.0, 0.0, 1.0])

        self.smoothing_length = 12
        self.deuler_history = np.zeros((self.smoothing_length, 3))
        self.dt_history = np.full((self.smoothing_length, 1), 1e-2)
        self.buf_idx = 0
        self.timuprev = time.time()
        self.body_ang_vel = np.zeros(3)
        self.smoothing_ratio = 0.2

        # RC state
        self.mode = 0
        self.ctrlmode_left = 0
        self.ctrlmode_right = 0
        self.left_stick = [0.0, 0.0]
        self.right_stick = [0.0, 0.0]
        self.left_upper_switch = 0
        self.right_upper_switch = 0
        self.left_lower_left_switch = 0
        self.right_lower_right_switch = 0
        self.left_upper_switch_pressed = False
        self.right_upper_switch_pressed = False

        self.cmd_phase, self.cmd_offset = 0.5, 0.0
        self.cmd_bound, self.cmd_duration = 0.0, 0.5
        self.received_first_legdata = False

        # camera pipeline (reference cheetah_state_estimator.py:114-124,
        # 318-360): 5 onboard cameras, frames land in camera_image_<name>
        self.use_cameras = use_cameras
        self.camera_names = list(msg.CAMERA_NAMES)
        self.camera_images = {name: None for name in self.camera_names}
        self._frame_assembler = msg.FrameAssembler()

        bus.subscribe(msg.CHANNEL_LEG_CONTROL, self._legdata_cb)
        bus.subscribe(msg.CHANNEL_STATE_ESTIMATOR, self._imu_cb)
        bus.subscribe(msg.CHANNEL_RC_COMMAND, self._rc_cb)
        if use_cameras:
            bus.subscribe(msg.CHANNEL_CAMERA, self._camera_cb)

    # -- accessors (sim joint order) --------------------------------------
    def get_dof_pos(self):
        return self.joint_pos[self.JOINT_IDXS]

    def get_dof_vel(self):
        return self.joint_vel[self.JOINT_IDXS]

    def get_tau_est(self):
        return self.tau_est[self.JOINT_IDXS]

    def get_gravity_vector(self):
        return self.R.T @ np.array([0.0, 0.0, -1.0])

    def get_body_angular_vel(self):
        est = np.mean(self.deuler_history / self.dt_history, axis=0)
        self.body_ang_vel = (self.smoothing_ratio * est
                             + (1 - self.smoothing_ratio) * self.body_ang_vel)
        return self.body_ang_vel

    def get_body_linear_vel(self):
        return self.R.T @ self.world_lin_vel

    def get_contact_state(self):
        return self.contact_state[self.CONTACT_IDXS]

    def get_rpy(self):
        return self.euler

    def get_yaw(self):
        return self.euler[2]

    # -- camera accessors (reference :245-258) -----------------------------
    def get_camera_front(self):
        return self.camera_images["front"]

    def get_camera_bottom(self):
        return self.camera_images["bottom"]

    def get_camera_left(self):
        return self.camera_images["left"]

    def get_camera_right(self):
        return self.camera_images["right"]

    def get_camera_rear(self):
        return self.camera_images["rear"]

    def get_buttons(self):
        return np.array([self.left_lower_left_switch, self.left_upper_switch,
                         self.right_lower_right_switch, self.right_upper_switch])

    def get_command(self):
        """RC -> 15-dim command (reference :148-221)."""
        modes_left = ["body_height", "lat_vel", "stance_width"]
        modes_right = ["step_frequency", "footswing_height", "body_pitch"]
        if self.left_upper_switch_pressed:
            self.ctrlmode_left = (self.ctrlmode_left + 1) % 3
            self.left_upper_switch_pressed = False
        if self.right_upper_switch_pressed:
            self.ctrlmode_right = (self.ctrlmode_right + 1) % 3
            self.right_upper_switch_pressed = False
        mode_left = modes_left[self.ctrlmode_left]
        mode_right = modes_right[self.ctrlmode_right]

        cmd_x = 1 * self.left_stick[1]
        cmd_yaw = -1 * self.right_stick[0]
        cmd_y, cmd_height, cmd_freq = 0.0, 0.0, 3.0
        cmd_footswing, cmd_stance_width, cmd_stance_length = 0.08, 0.33, 0.40
        cmd_ori_pitch = cmd_ori_roll = 0.0

        if mode_left == "body_height":
            cmd_height = 0.3 * self.left_stick[0]
        elif mode_left == "lat_vel":
            cmd_y = 0.6 * self.left_stick[0]
        elif mode_left == "stance_width":
            cmd_stance_width = 0.275 + 0.175 * self.left_stick[0]
        if mode_right == "step_frequency":
            cmd_freq = (1 + self.right_stick[1]) / 2 * 2.0 + 2.0
        elif mode_right == "footswing_height":
            cmd_footswing = max(0, self.right_stick[1]) * 0.32 + 0.03
        elif mode_right == "body_pitch":
            cmd_ori_pitch = -0.4 * self.right_stick[1]

        gait_table = {0: (0.5, 0.0, 0.0), 1: (0.0, 0.0, 0.0),
                      2: (0.0, 0.5, 0.0), 3: (0.0, 0.0, 0.5)}
        self.cmd_phase, self.cmd_offset, self.cmd_bound = gait_table.get(
            self.mode, (0.5, 0.0, 0.0))
        self.cmd_duration = 0.5

        return np.array([
            cmd_x, cmd_y, cmd_yaw, cmd_height, cmd_freq, self.cmd_phase,
            self.cmd_offset, self.cmd_bound, self.cmd_duration, cmd_footswing,
            cmd_ori_pitch, cmd_ori_roll, cmd_stance_width, cmd_stance_length,
            0.0])

    # -- callbacks ---------------------------------------------------------
    def _legdata_cb(self, payload: bytes):
        if not self.received_first_legdata:
            self.received_first_legdata = True
        m = msg.LegControlData.decode(payload)
        self.joint_pos = np.array(m.q)
        self.joint_vel = np.array(m.qd)
        self.tau_est = np.array(m.tau_est)

    def _imu_cb(self, payload: bytes):
        m = msg.StateEstimate.decode(payload)
        self.euler = np.array(m.rpy)
        self.R = rotation_from_rpy(self.euler)
        self.contact_state = 1.0 * (np.array(m.contact_estimate) > 200)
        now = time.time()
        i = self.buf_idx % self.smoothing_length
        self.deuler_history[i] = self.euler - self.euler_prev
        self.dt_history[i] = max(now - self.timuprev, 1e-4)
        self.timuprev = now
        self.buf_idx += 1
        self.euler_prev = self.euler.copy()

    def _camera_cb(self, payload: bytes):
        """Reassemble fragments; cam ids are 1-based like the reference's
        camera1..camera5 channels (cheetah_state_estimator.py:318-334)."""
        done = self._frame_assembler.push(payload)
        if done is not None:
            cam_id, img = done
            if 1 <= cam_id <= len(self.camera_names):
                self.camera_images[self.camera_names[cam_id - 1]] = img

    def _rc_cb(self, payload: bytes):
        m = msg.RcCommand.decode(payload)
        self.left_upper_switch_pressed = bool(
            (m.left_upper_switch and not self.left_upper_switch)
            or self.left_upper_switch_pressed)
        self.right_upper_switch_pressed = bool(
            (m.right_upper_switch and not self.right_upper_switch)
            or self.right_upper_switch_pressed)
        self.mode = m.mode
        self.left_stick = [m.left_stick_x, m.left_stick_y]
        self.right_stick = [m.right_stick_x, m.right_stick_y]
        self.left_upper_switch = m.left_upper_switch
        self.right_upper_switch = m.right_upper_switch
        self.left_lower_left_switch = m.left_lower_left_switch
        self.right_lower_right_switch = m.right_lower_right_switch

    def spin(self):
        self.bus.spin()
