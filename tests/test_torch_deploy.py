"""The port's deploy stack (walk_these_ways_tpu_torch/deploy/) against the
JAX package's, and on its own UDP port.

The deploy stack is numpy on both sides (the robot's computer has no GPU),
so messages, observations and policy actions must be equal bit for bit.
The port's bus tests and its bridge loopback run on ports of their own
(PUBSUB_PORT, BRIDGE_PORT, CAMERA_PORT), never on the JAX tests' 7801 and
7667: tier-1 runs tests/test_deploy.py's loopback on another worker at the
same moment, and two bridges on one port would answer each other's
targets.
"""
import json
import os
import pickle
import subprocess
import time

import numpy as np
import pytest
import torch

from walk_these_ways_tpu.deploy import agent as j_agent
from walk_these_ways_tpu.deploy import deploy_policy as j_deploy
from walk_these_ways_tpu.deploy import messages as j_msg
from walk_these_ways_tpu import go1_config as j_cfg

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.deploy import agent as t_agent
from walk_these_ways_tpu_torch.deploy import bridge
from walk_these_ways_tpu_torch.deploy import deploy_policy as t_deploy
from walk_these_ways_tpu_torch.deploy import messages as msg
from walk_these_ways_tpu_torch.deploy.bus import DEFAULT_PORT, Bus
from walk_these_ways_tpu_torch.deploy.command_profile import (
    ConstantAccelerationProfile, ElegantForwardProfile, ElegantGaitProfile,
    ElegantYawProfile, KeyboardCommandProfile, RCControllerProfileAccel)
from walk_these_ways_tpu_torch.envs.go1_env import LeggedRobotEnv
from walk_these_ways_tpu_torch.learn.runner import Runner
from walk_these_ways_tpu_torch.models.robot import (default_dof_pos, go1,
                                                    pd_gains)
from walk_these_ways_tpu_torch.scripts import actuator_net_train

torch.set_num_threads(1)

PUBSUB_PORT = 7811
BRIDGE_PORT = 7813
CAMERA_PORT = 7815
STEPS = 30         # policy steps of the deploy loop against the bridge


# ---------------------------------------------------------------------------
# messages: the same bytes as the JAX package's
# ---------------------------------------------------------------------------

def _fields(seed):
    rs = np.random.RandomState(seed)
    f = lambda n: [float(np.float32(v)) for v in rs.randn(n)]
    return dict(
        LegControlData=dict(q=f(12), qd=f(12), tau_est=f(12)),
        PdTauTargets=dict(q_des=f(12), qd_des=f(12), kp=f(12), kd=f(12),
                          tau_ff=f(12), id=int(rs.randint(-3, 3))),
        RcCommand=dict(left_stick_x=f(1)[0], left_stick_y=f(1)[0],
                       right_stick_x=f(1)[0], right_stick_y=f(1)[0],
                       knob=f(1)[0], mode=int(rs.randint(0, 9)),
                       left_upper_switch=1, left_lower_left_switch=0,
                       right_upper_switch=int(rs.randint(0, 2)),
                       right_lower_right_switch=1),
        StateEstimate=dict(p=f(3), vWorld=f(3), rpy=f(3), omegaBody=f(3),
                           quat=f(4), aBody=f(3), contact_estimate=f(4)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["LegControlData", "PdTauTargets",
                                  "RcCommand", "StateEstimate"])
def test_message_bytes_equal_the_jax_package(name, seed):
    kw = _fields(seed)[name]
    data = getattr(msg, name)(**kw).encode()
    assert data == getattr(j_msg, name)(**kw).encode()
    assert getattr(msg, name).decode(data) == getattr(msg, name)(**kw)
    assert msg.__dict__[name].FMT == j_msg.__dict__[name].FMT


def test_channels_and_camera_fragments_equal_the_jax_package():
    for k in ("CHANNEL_LEG_CONTROL", "CHANNEL_STATE_ESTIMATOR",
              "CHANNEL_RC_COMMAND", "CHANNEL_PD_TARGETS", "CHANNEL_CAMERA",
              "CAMERA_NAMES"):
        assert getattr(msg, k) == getattr(j_msg, k)
    img = np.random.RandomState(4).randint(0, 256, (200, 464, 3),
                                           dtype=np.uint8)
    assert msg.CameraFrame.encode_fragments(3, 70000, img) == \
        j_msg.CameraFrame.encode_fragments(3, 70000, img)


def test_message_roundtrip():
    """tests/test_deploy.py's round trip, through the port's messages."""
    m = msg.LegControlData(q=list(np.arange(12.0)),
                           qd=list(np.arange(12.0) * 2),
                           tau_est=list(np.arange(12.0) * 3))
    m2 = msg.LegControlData.decode(m.encode())
    np.testing.assert_allclose(m2.q, m.q)
    np.testing.assert_allclose(m2.tau_est, m.tau_est)
    t = msg.PdTauTargets(q_des=[0.1] * 12, kp=[20.0] * 12, kd=[0.5] * 12,
                         id=-1)
    t2 = msg.PdTauTargets.decode(t.encode())
    assert t2.id == -1
    np.testing.assert_allclose(t2.kp, t.kp)
    r = msg.RcCommand(left_stick_y=0.5, mode=2, right_upper_switch=1)
    r2 = msg.RcCommand.decode(r.encode())
    assert r2.mode == 2 and r2.right_upper_switch == 1
    assert abs(r2.left_stick_y - 0.5) < 1e-6
    s = msg.StateEstimate(rpy=[0.1, 0.2, 0.3], contact_estimate=[250.0] * 4)
    s2 = msg.StateEstimate.decode(s.encode())
    np.testing.assert_allclose(s2.rpy, s.rpy, atol=1e-6)


# ---------------------------------------------------------------------------
# the bus and the bridge, on the port's own UDP ports
# ---------------------------------------------------------------------------

def test_bus_pubsub():
    bus = Bus(port=PUBSUB_PORT)
    got = []
    bus.subscribe("chan_a", lambda p: got.append(p))
    bus.publish("chan_a", b"hello")
    deadline = time.time() + 2.0
    while not got and time.time() < deadline:
        bus.handle_once(timeout=0.1)
    bus.close()
    assert got == [b"hello"]


@pytest.fixture(scope="module")
def bridge_binary():
    return bridge.build(port=BRIDGE_PORT)


def test_bridge_is_built_per_port_into_the_build_dir(bridge_binary):
    assert DEFAULT_PORT == 7667
    assert os.path.basename(os.path.dirname(bridge_binary)).startswith(
        f"udp_bridge_{BRIDGE_PORT}_")
    assert bridge.build(port=BRIDGE_PORT) == bridge_binary
    assert not os.path.exists(os.path.join(bridge.CPP, "udp_bridge"))


def test_bridge_loopback(bridge_binary):
    """End-to-end: the C++ bridge (sim robot) <-> the Python bus on the
    port's own UDP port: the sim robot's joints move toward the published
    PD targets in the republished leg_control_data."""
    proc = subprocess.Popen([bridge_binary, "--sim", "--ticks", "4000"],
                            stdout=subprocess.PIPE)
    try:
        bus = Bus(port=BRIDGE_PORT)
        legdata = []
        bus.subscribe(msg.CHANNEL_LEG_CONTROL,
                      lambda p: legdata.append(msg.LegControlData.decode(p)))
        deadline = time.time() + 5.0
        while not legdata and time.time() < deadline:
            bus.handle_once(timeout=0.1)
        assert legdata, "no leg_control_data from bridge"
        # per-leg (hip, thigh, calf) targets inside the joint limits — the
        # bridge's PositionLimit layer clamps anything outside
        q_des = [0.3, 0.9, -1.8] * 4
        target = msg.PdTauTargets(q_des=q_des, kp=[20.0] * 12,
                                  kd=[0.5] * 12)
        t_end = time.time() + 3.0
        while time.time() < t_end:
            bus.publish(msg.CHANNEL_PD_TARGETS, target.encode())
            for _ in range(20):   # drain the 500 Hz telemetry flood
                bus.handle_once(timeout=0.001)
            if np.all(np.abs(np.array(legdata[-1].q) - q_des) < 0.01):
                break             # tracked (the check below is at 0.1)
        q = np.array(legdata[-1].q)
        bus.close()
        assert np.all(np.abs(q - np.array(q_des)) < 0.1), (
            f"joints did not track: {q} ({len(legdata)} msgs)")
    finally:
        proc.terminate()
        proc.wait(timeout=5)


# ---------------------------------------------------------------------------
# the policy loader: the JAX loader's bits, the port's own actors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Exports of a port Runner on the CPU (small_train_cfg(4), as the JAX
    deploy test builds its own), cse and rma."""
    env = LeggedRobotEnv(t_cfg.small_train_cfg(4), device="cpu")
    out = {}
    for algo in ("cse", "rma"):
        d = tmp_path_factory.mktemp(algo)
        kw = {} if algo == "cse" else dict(algo="rma")
        r = Runner(env, log_dir=str(d), seed=3, **kw)
        r.export_policy(str(d))
        out[algo] = (str(d / "policy_latest.npz"), r)
    return env, out


def _inputs(env, seed, n=8):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 1, env.num_obs).astype(np.float32),
            rs.randn(n, 1, env.num_obs_history).astype(np.float32))


@pytest.mark.parametrize("algo", ["cse", "rma"])
def test_load_student_policy_is_bit_equal_to_the_jax_loader(exports, algo):
    env, out = exports
    path, _ = out[algo]
    assert str(np.load(path)["meta/variant"]) == algo
    ours, theirs = (m.load_student_policy(path) for m in (t_deploy, j_deploy))
    for obs, hist in zip(*_inputs(env, 0)):
        a = ours({"obs": obs, "obs_history": hist})
        b = theirs({"obs": obs, "obs_history": hist})
        assert a.dtype == b.dtype and a.shape == (12,)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("algo", ["cse", "rma"])
def test_export_policy_load_student_roundtrip(exports, algo):
    """The port Runner's export, read by the port's numpy loader, against
    the trained policy's actor (`actor_mean` for cse, `student_mean` for
    rma) on the same inputs: float32 products in other orders."""
    env, out = exports
    path, runner = out[algo]
    policy = t_deploy.load_student_policy(path)
    pol = runner.train_state.policy
    obs, hist = _inputs(env, 1)
    got = np.stack([policy({"obs": o, "obs_history": h})
                    for o, h in zip(obs, hist)])
    with torch.no_grad():
        if algo == "cse":
            want = pol.actor_mean(torch.from_numpy(hist[:, 0]))
        else:
            want = pol.student_mean(torch.from_numpy(obs[:, 0]),
                                    torch.from_numpy(hist[:, 0]))
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-6)


def test_rma_export_is_not_read_as_cse(exports):
    """The rma actor reads obs ⊕ latent: the variant decides the input."""
    env, out = exports
    z = np.load(out["rma"][0])
    assert z["actor/w0"].shape[0] == env.num_obs + z["adaptation/b2"].shape[0]


# ---------------------------------------------------------------------------
# the agent: the JAX agent's observation and targets, exactly
# ---------------------------------------------------------------------------

class _StubSE:
    JOINT_IDXS = [3, 4, 5, 0, 1, 2, 9, 10, 11, 6, 7, 8]
    use_cameras = False

    def __init__(self, seed):
        rs = np.random.RandomState(seed)
        g = rs.randn(3)
        self.v = dict(gravity=g / np.linalg.norm(g), q=0.3 * rs.randn(12),
                      qd=rs.randn(12), lin=rs.randn(3), ang=rs.randn(3),
                      yaw=float(rs.randn()),
                      contact=rs.randint(0, 2, 4).astype(float))

    def get_gravity_vector(self):
        return self.v["gravity"].copy()

    def get_dof_pos(self):
        return self.v["q"].copy()

    def get_dof_vel(self):
        return self.v["qd"].copy()

    def get_body_linear_vel(self):
        return self.v["lin"].copy()

    def get_body_angular_vel(self):
        return self.v["ang"].copy()

    def get_yaw(self):
        return self.v["yaw"]

    def get_contact_state(self):
        return self.v["contact"].copy()


class _StubProfile:
    def __init__(self, seed):
        self.cmd = np.random.RandomState(seed + 100).randn(15)

    def get_command(self, t):
        return self.cmd.copy(), False


class _RecordingBus:
    def __init__(self):
        self.sent = []

    def publish(self, channel, payload):
        self.sent.append((channel, payload))


def _agents(seed):
    model = go1()
    ddp = default_dof_pos(model, dict(t_cfg.GO1_DEFAULT_JOINT_ANGLES),
                          device="cpu").numpy()
    out = []
    for mod, cfg in ((j_agent, j_cfg.mob_train_cfg(num_envs=1)),
                     (t_agent, t_cfg.mob_train_cfg(num_envs=1))):
        p, d = pd_gains(model, dict(cfg.control.stiffness),
                        dict(cfg.control.damping), device="cpu")
        out.append(mod.Agent(cfg, _StubSE(seed), _StubProfile(seed),
                             _RecordingBus(), ddp, p.numpy(), d.numpy()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_agent_get_obs_equals_the_jax_agent(seed):
    ja, ta = _agents(seed)
    for step in range(3):
        act = np.random.RandomState(seed * 10 + step).randn(12)
        for a in (ja, ta):
            a.last_actions = a.actions.copy()
            a.actions = act.copy()
            a.clock_inputs = np.sin(np.arange(4) + step)
        o_t, o_j = ta.get_obs(), ja.get_obs()
        assert o_t.dtype == o_j.dtype == np.float32
        assert o_t.shape == (ta.num_obs,)
        np.testing.assert_array_equal(o_t, o_j)
        ja.publish_action(act.copy())
        ta.publish_action(act.copy())
        assert ta.bus.sent == ja.bus.sent
        np.testing.assert_array_equal(ta.torques, ja.torques)


# ---------------------------------------------------------------------------
# the whole loop against the bridge, and its log
# ---------------------------------------------------------------------------

def test_deploy_loop_against_the_bridge(bridge_binary, exports, tmp_path):
    """`load_and_run_policy` on the cse export for STEPS steps (50 Hz)
    against the bridge's sim
    robot, on the port's own UDP port, with a second bus listening: leg data
    arrives, every published PD target lies inside the joint limits, and
    the deploy log saved at the end is the actuator-net trainer's input."""
    _, out = exports
    path, _ = out["cse"]
    model = go1()
    lo = model.dof_lower[_StubSE.JOINT_IDXS]
    hi = model.dof_upper[_StubSE.JOINT_IDXS]
    proc = subprocess.Popen([bridge_binary, "--sim", "--ticks", "10000"],
                            stdout=subprocess.PIPE)
    mon = Bus(port=BRIDGE_PORT)
    targets, legs = [], []
    mon.subscribe(msg.CHANNEL_PD_TARGETS,
                  lambda p: targets.append(msg.PdTauTargets.decode(p)))
    mon.subscribe(msg.CHANNEL_LEG_CONTROL, lambda p: legs.append(1))
    mon.spin()
    try:
        log = t_deploy.load_and_run_policy(
            path, max_steps=STEPS, wait_for_button=False, port=BRIDGE_PORT,
            log_root=str(tmp_path / "logs"))
    finally:
        mon.close()
        proc.terminate()
        proc.wait(timeout=5)
    with open(log, "rb") as f:
        rec = pickle.load(f)["hardware_closed_loop"]
    assert len(rec["joint_pos"]) == STEPS
    q = np.concatenate(rec["joint_pos"])
    q_tgt = np.concatenate(rec["joint_pos_target"])
    # the policy loop's targets as logged, inside the limits, are the ones
    # on the wire in SDK order (the calibration walk before them starts
    # from the sim robot's q = 0, outside the calf range, and the bridge
    # clamps those); the listener may drop a datagram under load
    assert np.all(q_tgt >= model.dof_lower)
    assert np.all(q_tgt <= model.dof_upper)
    sent = q_tgt[:, _StubSE.JOINT_IDXS]
    heard = np.array([t.q_des for t in targets])
    matched = (np.abs(heard[:, None] - sent[None]).max(-1) <= 1e-6).any(-1)
    assert legs and matched.sum() > 0
    assert np.all(heard[matched] >= lo) and np.all(heard[matched] <= hi)
    assert np.abs(q[-1]).max() > 0.1                 # leg data was read
    assert np.abs(q[-1] - q_tgt[-1]).max() < 0.2     # and tracked
    x, y = actuator_net_train.build_dataset(str(tmp_path / "logs"))
    rows = (STEPS - 2) * 12
    assert x.shape == (rows, 6) and y.shape == (rows, 1)
    assert np.isfinite(x).all() and np.isfinite(y).all()


# ---------------------------------------------------------------------------
# camera frames, command profiles, network config (test_deploy_extras.py)
# ---------------------------------------------------------------------------

def test_camera_frame_roundtrip_small():
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (116, 100, 3), dtype=np.uint8)
    frags = msg.CameraFrame.encode_fragments(cam_id=1, frame_seq=7, image=img)
    assert len(frags) == int(np.ceil(img.nbytes / msg.CameraFrame.MAX_FRAG))
    asm = msg.FrameAssembler()
    out = None
    for frag in frags:
        out = asm.push(frag)
    assert out is not None
    cam, got = out
    assert cam == 1
    np.testing.assert_array_equal(got, img)


def test_camera_frame_roundtrip_large_out_of_order():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 256, (200, 464, 3), dtype=np.uint8)
    frags = msg.CameraFrame.encode_fragments(cam_id=3, frame_seq=42, image=img)
    assert len(frags) == int(np.ceil(278400 / msg.CameraFrame.MAX_FRAG))
    asm = msg.FrameAssembler()
    order = rng.permutation(len(frags))
    outs = [asm.push(frags[i]) for i in order]
    assert all(o is None for o in outs[:-1])
    cam, got = outs[-1]
    assert cam == 3
    np.testing.assert_array_equal(got, img)


def test_camera_frame_drops_stale_sequence():
    rng = np.random.RandomState(2)
    img_a = rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)
    img_b = rng.randint(0, 256, (64, 64, 3), dtype=np.uint8)
    small = msg.CameraFrame
    old_max = small.MAX_FRAG
    try:
        small.MAX_FRAG = 4096            # force multi-fragment
        frags_a = small.encode_fragments(1, 1, img_a)
        frags_b = small.encode_fragments(1, 2, img_b)
        asm = msg.FrameAssembler()
        assert asm.push(frags_a[0]) is None          # partial old frame
        outs = [asm.push(f) for f in frags_b]
        cam, got = outs[-1]
        np.testing.assert_array_equal(got, img_b)
    finally:
        small.MAX_FRAG = old_max


def test_state_estimator_camera_pipeline():
    from walk_these_ways_tpu_torch.deploy.state_estimator import (
        StateEstimator)

    bus = Bus(port=PUBSUB_PORT)
    try:
        se = StateEstimator(bus, use_cameras=True)
        rng = np.random.RandomState(3)
        img = rng.randint(0, 256, (116, 100, 3), dtype=np.uint8)
        for frag in msg.CameraFrame.encode_fragments(2, 0, img):
            bus.publish(msg.CHANNEL_CAMERA, frag)
        for _ in range(10):
            if not bus.handle_once(timeout=0.5):
                break
        got = se.get_camera_bottom()                 # cam_id 2 -> "bottom"
        assert got is not None
        np.testing.assert_array_equal(got, img)
        assert se.get_camera_front() is None
    finally:
        bus.close()


def test_elegant_forward_profile():
    p = ElegantForwardProfile(dt=0.02, max_speed=2.0, accel_time=1.0,
                              duration=2.0, deaccel_time=1.0)
    v0, _ = p.get_command(0.0)
    v_mid, _ = p.get_command(2.0)
    v_end, _ = p.get_command(3.9)
    assert v0[0] == 0.0
    assert v_mid[0] == pytest.approx(2.0)
    assert v_end[0] < 0.5
    assert np.all(v_mid[1:] == 0.0)


def test_elegant_yaw_profile():
    p = ElegantYawProfile(dt=0.02, max_speed=1.0, zero_buf_time=0.5,
                          accel_time=0.5, duration=1.0, deaccel_time=0.5,
                          yaw_rate=0.7)
    v_buf, _ = p.get_command(0.25)
    v_hold, _ = p.get_command(1.5)
    assert v_buf[0] == 0.0 and v_buf[2] == 0.0
    assert v_hold[0] == pytest.approx(1.0)
    assert v_hold[2] == pytest.approx(0.7)


def test_elegant_gait_profile(tmp_path):
    seq = {"x_vel_cmd": [0.0, 1.0, 1.5], "yaw_vel_cmd": [0.0, 0.0, 0.3],
           "height_cmd": [0.0, 0.1, 0.1], "frequency_cmd": [3.0, 3.0, 3.0],
           "offset_cmd": [0.0, 0.0, 0.0], "phase_cmd": [0.5, 0.5, 0.5],
           "bound_cmd": [0.0, 0.0, 0.0], "duration_cmd": [0.5, 0.5, 0.5]}
    path = tmp_path / "gait.json"
    path.write_text(json.dumps(seq))
    p = ElegantGaitProfile(dt=1.0, path=str(path))
    c1, _ = p.get_command(1.0)
    assert c1[0] == 1.0 and c1[4] == 3.0 and c1[5] == 0.5
    c2, _ = p.get_command(2.0)
    assert c2[0] == 1.5 and c2[2] == pytest.approx(0.3)


class _FakeSE:
    def __init__(self):
        self.cmd = np.zeros(19)
        self.buttons = np.zeros(4)

    def get_command(self):
        return self.cmd.copy()

    def get_buttons(self):
        return self.buttons.copy()


def test_rc_accel_profile_integrates():
    se = _FakeSE()
    p = RCControllerProfileAccel(dt=0.02, state_estimator=se, x_scale=1.0)
    se.cmd[0] = 1.0
    for _ in range(100):
        cmd, _ = p.get_command(0.0)
    assert cmd[0] == pytest.approx(100 * 1.0 / 100.0)
    se.cmd[0] = 0.0
    cmd2, _ = p.get_command(0.0)
    assert cmd2[0] == pytest.approx(cmd[0])


def test_rc_accel_triggered_command():
    se = _FakeSE()
    p = RCControllerProfileAccel(dt=0.02, state_estimator=se)
    trig = ConstantAccelerationProfile(dt=0.02, max_speed=2.0, accel_time=0.1)
    p.register_triggered_command(0, trig)
    se.buttons[0] = 1
    cmd, _ = p.get_command(5.0)
    assert cmd[0] == pytest.approx(2.0)


def test_keyboard_profile_keys():
    p = KeyboardCommandProfile(dt=0.02, x_scale=2.0, yaw_scale=0.5)
    p.press("w")
    cmd, _ = p.get_command(0.0)
    assert cmd[0] == pytest.approx(2.0)
    p.press("w")
    cmd, _ = p.get_command(0.0)
    assert cmd[0] == 0.0
    p.press("q")
    cmd, _ = p.get_command(0.0)
    assert cmd[2] == pytest.approx(0.5)
    p.press(" ")
    cmd, _ = p.get_command(0.0)
    assert np.all(cmd[:3] == 0.0)
    assert cmd[4] == 3.0 and cmd[5] == 0.5


def test_network_config_interface_discovery(monkeypatch):
    from walk_these_ways_tpu_torch.deploy import network_config as nc

    fake = ("1: lo    inet 127.0.0.1/8 scope host lo\\       "
            "valid_lft forever preferred_lft forever\n"
            "2: eth0    inet 10.0.0.5/24 brd 10.0.0.255 scope global eth0\n"
            "3: eth1    inet 192.168.123.14/24 brd 192.168.123.255 "
            "scope global eth1\n")

    class R:
        stdout = fake

    monkeypatch.setattr(subprocess, "run", lambda *a, **k: R())
    ifs = nc.list_interfaces()
    assert ifs == {"lo": ["127.0.0.1"], "eth0": ["10.0.0.5"],
                   "eth1": ["192.168.123.14"]}
    assert nc.get_likely_iface() == "eth1"


def test_check_camera_msgs_self_test():
    from walk_these_ways_tpu_torch.deploy.check_camera_msgs import main

    rep = main(seconds=0.5, self_test=True, port=CAMERA_PORT)
    assert "front" in rep
    fps, shape = rep["front"]
    assert fps > 5.0
    assert shape == (30, 40, 3)
