"""Command sources for deployment.

Rebuild of the reference CommandProfile family (reference:
go1_gym_deploy/utils/command_profile.py:4-231): time-indexed profiles,
constant commands, and the RC-controller profile that reads the joystick
through the state estimator.  Commands are the 15-dim vector
[vx, vy, vyaw, height, freq, phase, offset, bound, duration, footswing,
pitch, roll, stance_width, stance_length, aux].
"""
from __future__ import annotations

import numpy as np


class CommandProfile:
    def __init__(self, dt, max_time_s=10.0):
        self.dt = dt
        self.max_timestep = int(max_time_s / dt)
        self.commands = np.zeros((self.max_timestep, 15))

    def get_command(self, t):
        timestep = int(min(t / self.dt, self.max_timestep - 1))
        return self.commands[timestep], False


class ConstantAccelerationProfile(CommandProfile):
    """reference command_profile.py:24-36"""

    def __init__(self, dt, max_speed, accel_time, zero_buffer_time=0.0):
        super().__init__(dt)
        zero_buffer = int(zero_buffer_time / dt)
        accel_steps = int(accel_time / dt)
        t = np.arange(self.max_timestep - zero_buffer) * dt
        v = np.minimum(t / accel_time * max_speed, max_speed)
        self.commands[zero_buffer:, 0] = v


class ConstantGaitProfile(CommandProfile):
    """Fixed gait + velocity command (the play.py eval protocol)."""

    def __init__(self, dt, vx=1.5, gait=(0.5, 0.0, 0.0), freq=3.0,
                 footswing=0.08, stance_width=0.25, duration=0.5):
        super().__init__(dt)
        self.commands[:, 0] = vx
        self.commands[:, 4] = freq
        self.commands[:, 5:8] = np.asarray(gait)
        self.commands[:, 8] = duration
        self.commands[:, 9] = footswing
        self.commands[:, 12] = stance_width


class ElegantForwardProfile(CommandProfile):
    """Trapezoidal forward-velocity ramp (reference command_profile.py:38-54)."""

    def __init__(self, dt, max_speed, accel_time, duration, deaccel_time,
                 zero_buf_time=0.0):
        zero_buf = int(zero_buf_time / dt)
        accel = int(accel_time / dt)
        hold = int(duration / dt)
        deaccel = int(deaccel_time / dt)
        total_s = zero_buf_time + accel_time + duration + deaccel_time
        super().__init__(dt, max(total_s, dt))
        vx = np.concatenate([
            np.zeros(zero_buf),
            np.linspace(0.0, max_speed, accel, endpoint=False),
            np.full(hold, max_speed),
            np.linspace(max_speed, 0.0, deaccel)])
        n = min(len(vx), self.max_timestep)
        self.commands[:n, 0] = vx[:n]


class ElegantYawProfile(CommandProfile):
    """Forward ramp with a yaw-rate hold phase (reference
    command_profile.py:57-76)."""

    def __init__(self, dt, max_speed, zero_buf_time, accel_time, duration,
                 deaccel_time, yaw_rate):
        zero_buf = int(zero_buf_time / dt)
        accel = int(accel_time / dt)
        hold = int(duration / dt)
        deaccel = int(deaccel_time / dt)
        total_s = zero_buf_time + accel_time + duration + deaccel_time
        super().__init__(dt, max(total_s, dt))
        vx = np.concatenate([
            np.zeros(zero_buf),
            np.linspace(0.0, max_speed, accel, endpoint=False),
            np.full(hold, max_speed),
            np.linspace(max_speed, 0.0, deaccel)])
        yaw = np.concatenate([
            np.zeros(zero_buf + accel), np.full(hold, yaw_rate),
            np.zeros(deaccel)])
        n = min(len(vx), self.max_timestep)
        self.commands[:n, 0] = vx[:n]
        self.commands[:n, 2] = yaw[:n]


class ElegantGaitProfile(CommandProfile):
    """Scripted full-command sequence loaded from a JSON file (reference
    command_profile.py:79-100).  The JSON maps
    {x_vel_cmd, yaw_vel_cmd, height_cmd, frequency_cmd, offset_cmd,
    phase_cmd, bound_cmd, duration_cmd} -> per-timestep lists."""

    JSON_KEYS = {"x_vel_cmd": 0, "yaw_vel_cmd": 2, "height_cmd": 3,
                 "frequency_cmd": 4, "phase_cmd": 5, "offset_cmd": 6,
                 "bound_cmd": 7, "duration_cmd": 8}

    def __init__(self, dt, path):
        import json

        with open(path) as f:
            seq = json.load(f)
        n_steps = len(seq["x_vel_cmd"])
        super().__init__(dt, max(n_steps * dt, dt))
        for key, col in self.JSON_KEYS.items():
            if key in seq:
                vals = np.asarray(seq[key], dtype=np.float64)
                n = min(len(vals), self.max_timestep)
                self.commands[:n, col] = vals[:n]


class RCControllerProfile:
    """Joystick-driven commands (reference command_profile.py:97-176)."""

    def __init__(self, dt, state_estimator, x_scale=1.0, y_scale=1.0,
                 yaw_scale=1.0):
        self.dt = dt
        self.se = state_estimator
        self.x_scale = x_scale
        self.y_scale = y_scale
        self.yaw_scale = yaw_scale
        self.triggered_commands = {i: None for i in range(4)}
        self.currently_triggered = {i: 0 for i in range(4)}
        self.button_states = np.zeros(4)

    def register_triggered_command(self, button_idx, command_profile):
        self.triggered_commands[button_idx] = command_profile

    def get_command(self, t, probe=False):
        cmd = self.se.get_command()
        cmd = np.asarray(cmd, dtype=np.float64).copy()
        cmd[0] *= self.x_scale
        cmd[1] *= self.y_scale
        cmd[2] *= self.yaw_scale
        reset_timer = False
        # button-triggered profiles (command_profile.py:133-160)
        buttons = self.se.get_buttons()
        for i in range(4):
            if buttons[i] and self.button_states[i] == 0:
                if self.triggered_commands[i] is not None:
                    self.currently_triggered[i] = not self.currently_triggered[i]
                    reset_timer = True
            self.button_states[i] = buttons[i]
        for i in range(4):
            if self.currently_triggered[i] and self.triggered_commands[i] is not None:
                cmd, _ = self.triggered_commands[i].get_command(t)
        return cmd[:15], reset_timer


class RCControllerProfileAccel(RCControllerProfile):
    """Sticks command acceleration instead of velocity (reference
    command_profile.py:156-176): the velocity command integrates the stick
    deflection at 1/100 of the velocity-mode scales."""

    def __init__(self, dt, state_estimator, x_scale=1.0, y_scale=1.0,
                 yaw_scale=1.0):
        super().__init__(dt, state_estimator, x_scale=x_scale,
                         y_scale=y_scale, yaw_scale=yaw_scale)
        self.x_scale /= 100.0
        self.y_scale /= 100.0
        self.yaw_scale /= 100.0
        self.velocity_command = np.zeros(3)

    def get_command(self, t, probe=False):
        accel = np.asarray(self.se.get_command(), dtype=np.float64)
        self.velocity_command[0] += accel[0] * self.x_scale
        self.velocity_command[1] += accel[1] * self.y_scale
        self.velocity_command[2] += accel[2] * self.yaw_scale
        cmd = accel.copy()
        cmd[:3] = self.velocity_command
        buttons = self.se.get_buttons()
        for i in range(4):
            if buttons[i] and self.button_states[i] == 0:
                if self.triggered_commands[i] is not None:
                    self.currently_triggered[i] = not self.currently_triggered[i]
            self.button_states[i] = buttons[i]
        for i in range(4):
            if self.currently_triggered[i] and self.triggered_commands[i] is not None:
                cmd, _ = self.triggered_commands[i].get_command(t)
        return cmd[:15], False


class KeyboardCommandProfile:
    """Keyboard-driven commands (reference command_profile.py:179-226).

    The reference's KeyboardProfile reads keys through the IsaacGym viewer;
    here the listener is a raw-terminal thread (termios cbreak) so it works
    on the robot or in any tty: arrows / WASD steer [vx, vy], Q/E yaw,
    space zeroes.  Without a tty (tests, pipes) it degrades to the
    programmatic `set()` interface."""

    KEYMAP = {"w": (0, 1.0), "s": (0, -1.0), "a": (1, 1.0), "d": (1, -1.0),
              "q": (2, 1.0), "e": (2, -1.0)}
    ARROWS = {"A": (0, 1.0), "B": (0, -1.0), "D": (1, 1.0), "C": (1, -1.0)}

    def __init__(self, dt, x_scale=1.0, y_scale=0.6, yaw_scale=1.0,
                 listen=False):
        self.dt = dt
        self.scales = np.array([x_scale, y_scale, yaw_scale])
        self.keyb_command = np.zeros(3)
        self.command = np.zeros(15)
        self.command[4] = 3.0
        self.command[5] = 0.5
        self.command[8] = 0.5
        self.command[9] = 0.08
        self.command[12] = 0.33
        self.command[13] = 0.40
        self._running = False
        if listen:
            self.start_listening()

    # -- programmatic interface (works everywhere) -------------------------
    def set(self, **kw):
        idx = dict(vx=0, vy=1, vyaw=2, height=3, freq=4, phase=5, offset=6,
                   bound=7, duration=8, footswing=9, pitch=10, roll=11,
                   stance_width=12, stance_length=13)
        for k, v in kw.items():
            self.command[idx[k]] = v

    def press(self, key: str):
        """Feed one key event (used by the listener thread and by tests)."""
        if key == " ":
            self.keyb_command[:] = 0.0
        elif key in self.KEYMAP:
            axis, val = self.KEYMAP[key]
            self.keyb_command[axis] = (
                0.0 if self.keyb_command[axis] == val else val)
        self.command[0] = self.keyb_command[0] * self.scales[0]
        self.command[1] = self.keyb_command[1] * self.scales[1]
        self.command[2] = self.keyb_command[2] * self.scales[2]

    # -- tty listener ------------------------------------------------------
    def start_listening(self):
        import sys
        if not sys.stdin.isatty():
            return False
        import threading

        self._running = True

        def loop():
            import termios
            import tty
            fd = sys.stdin.fileno()
            old = termios.tcgetattr(fd)
            try:
                tty.setcbreak(fd)
                while self._running:
                    ch = sys.stdin.read(1)
                    if ch == "\x1b":                    # arrow escape seq
                        seq = sys.stdin.read(2)
                        if len(seq) == 2 and seq[1] in self.ARROWS:
                            axis, val = self.ARROWS[seq[1]]
                            self.press("wsad"[axis * 2 + (val < 0)])
                    else:
                        self.press(ch.lower())
            finally:
                termios.tcsetattr(fd, termios.TCSADRAIN, old)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return True

    def stop(self):
        self._running = False

    def get_command(self, t):
        return self.command.copy(), False
