"""Cross-engine physics validation against MuJoCo (the independent oracle).

The reference's physics authority is PhysX inside IsaacGym (reference:
go1_gym/envs/base/legged_robot.py:74-81, solver config
legged_robot_config.py:402-421), which cannot run here.  MuJoCo serves as
the independent oracle: the MJCF is generated from the very same RobotModel
the engine integrates (models/mjcf.py), so any trajectory disagreement is
attributable to the solvers, not the model data.  The engine half is the
port's dense route (`SimParams(use_pallas_contact=False)`: stock torch, the
box's M^-1 by `torch.linalg.inv`) at N = 1, on the card unless asked for the
CPU; the MuJoCo half runs on the host.

Experiments (each prints a PASS/FAIL line and dumps JSON):
  box_slide      kinetic friction: slide deceleration == mu * g
  box_incline    stick below arctan(mu), slide accel g(sin t - mu cos t) above
  box_rest       resting penetration depth
  box_bounce     restitution bounce ratio (vs analytic; MuJoCo has no
                 restitution parameter -- documented, engine-only check)
  go1_standing   steady standing: total normal force == weight in both
  go1_replay     closed-loop PD replay from identical states: base/joint
                 trajectory divergence over a 2 s horizon, for the exact,
                 exact50 and reuse solver modes, and MuJoCo's own chaos floor
  go1_replay_actuator  the same dance with torques from the actuator network

Each experiment is an engine half (`ENGINE_HALVES[name](device)`:
the engine's trajectories and its engine-only metrics and gates) and a
MuJoCo half (`run_<name>`: the MuJoCo rollout, the cross-engine metrics,
the full gate).  `--engine-only` runs the engine halves alone, where
MuJoCo is not installed (the card's machine): each experiment's seconds and
engine-only gate on a line, its trajectories in `<out>/<name>.engine.npz`.

Run:  python -m walk_these_ways_tpu_torch.scripts.mujoco_parity
          [--device cuda|cpu] [--out runs/mujoco_parity_torch] [--only NAME]
          [--engine-only]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..go1_config import GO1_DEFAULT_JOINT_ANGLES
from ..models import actuator_net as anet
from ..models import mjcf
from ..models.robot import box, default_dof_pos, go1
from ..physics import engine as E

# MuJoCo oracle runs at its own numerically-comfortable settings (1 ms
# steps, default solref "0.02 1" -- MuJoCo's guideline is timeconst >=
# 2*timestep) and is sampled at the engine's 5 ms substep cadence; the
# torque schedule is held constant across each 5-microstep window.
MJ_DT = 0.001


def _device(device) -> torch.device:
    """The engine half's device.  On the card the dense route's products
    must stay in float32, so TF32 is turned off (no env is built here to
    do it)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mujoco_parity runs the engine half on a CUDA device: "
                "torch.cuda.is_available() is False (pass --device cpu to "
                "run it on the CPU)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _row(state, info):
    """Env 0's (pos, quat, lin, ang, q, qd, report forces) in one copy to
    the host."""
    fields = (state.base_pos[0], state.base_quat[0], state.base_lin_vel[0],
              state.base_ang_vel[0], state.q[0], state.qd[0],
              info.report_forces[0])
    flat = _host(torch.cat([f.reshape(-1) for f in fields]))
    out, i = [], 0
    for f in fields:
        out.append(flat[i:i + f.numel()].reshape(tuple(f.shape)))
        i += f.numel()
    return tuple(out)


def _engine_sim(model, sim_params, state0, torques_fn, dyn, steps, dt,
                terrain=None, reuse=False):
    """Roll our engine; torques_fn(t, state) -> (N,12) np torques."""
    dev = state0.base_pos.device
    terrain = terrain if terrain is not None else E.flat_terrain(dev)
    state = state0
    traj = []
    if reuse:
        def ctrl(state, tau):
            cache = E.build_dynamics_cache(model, sim_params, state, dyn,
                                           terrain)
            p_cp = None
            for _ in range(4):
                state, info, p_cp = E.physics_substep_cached(
                    model, sim_params, state, tau, dyn, terrain, cache, p_cp)
            return state, info
        stride = 4
    else:
        def ctrl(state, tau):
            return E.physics_substep(model, sim_params, state, tau, dyn,
                                     terrain)
        stride = 1
    with torch.inference_mode():       # no autograd records at N = 1
        for t in range(0, steps, stride):
            tau = torch.as_tensor(np.asarray(torques_fn(t, state)),
                                  dtype=torch.float32, device=dev)
            state, info = ctrl(state, tau)
            traj.append(_row(state, info))
    return state, traj


def _mj_sim(xml, state0_np, torques_fn, steps, dt, hold=1):
    """Roll MuJoCo with the same torque schedule; returns the trajectory in
    our conventions, sampled once per engine substep (dt), with MuJoCo
    micro-stepping at MJ_DT in between.  `hold` re-evaluates torques_fn
    only every `hold` engine steps (to mirror a lower control rate)."""
    import mujoco

    mjm = mujoco.MjModel.from_xml_string(xml)
    sub = int(round(dt / mjm.opt.timestep))
    assert abs(sub * mjm.opt.timestep - dt) < 1e-12
    mjd = mujoco.MjData(mjm)
    pos, quat, lin, ang, q, qd = state0_np
    mjcf.set_mj_state(mjd, pos, quat, lin, ang, q, qd)
    mujoco.mj_forward(mjm, mjd)
    traj = []
    tau = None
    for t in range(steps):
        if t % hold == 0:
            tau = np.asarray(torques_fn(t, mjcf.get_mj_state(mjd)))
        if mjd.ctrl.shape[0]:
            mjd.ctrl[:] = tau[0]
        for _ in range(sub):
            mujoco.mj_step(mjm, mjd)
        p, qu, li, an, qq, dq = mjcf.get_mj_state(mjd)
        # total contact normal force on the robot (world z)
        fz = 0.0
        for c in range(mjd.ncon):
            f6 = np.zeros(6)
            mujoco.mj_contactForce(mjm, mjd, c, f6)
            # contact frame: row 0 is the normal
            R = mjd.contact[c].frame.reshape(3, 3)
            fz += (R.T @ f6[:3])[2]
        traj.append((p, qu, li, an, qq, dq, fz))
    return traj


def _tilt_deg(quat):
    """Angle between body z and world z from xyzw quaternions (deg)."""
    x, y, z, w = quat.T
    cz = 1.0 - 2.0 * (x * x + y * y)
    return np.rad2deg(np.arccos(np.clip(cz, -1.0, 1.0)))


def _traj_metrics(pos_a, qu_a, q_a, pos_b, qu_b, q_b):
    """Shared divergence metrics between two base/joint trajectories."""
    n = min(len(pos_a), len(pos_b))
    pos_a, qu_a, q_a = pos_a[:n], qu_a[:n], q_a[:n]
    pos_b, qu_b, q_b = pos_b[:n], qu_b[:n], q_b[:n]
    return dict(
        base_pos_rmse=float(np.sqrt(((pos_a - pos_b) ** 2).mean())),
        base_pos_max=float(np.abs(pos_a - pos_b).max()),
        base_z_rmse=float(np.sqrt(((pos_a[:, 2] - pos_b[:, 2]) ** 2).mean())),
        base_z_max=float(np.abs(pos_a[:, 2] - pos_b[:, 2]).max()),
        tilt_diff_max_deg=float(
            np.abs(_tilt_deg(qu_a) - _tilt_deg(qu_b)).max()),
        joint_rmse=float(np.sqrt(((q_a - q_b) ** 2).mean())),
        joint_max=float(np.abs(q_a - q_b).max()))


def _half(trajs, metrics=None, analytic_ok=None):
    """An experiment's engine half: `trajs` {mode: rows of (pos, quat, lin,
    ang, q, qd, report forces)}, `metrics` (engine-only, full horizon) and
    `analytic_ok` (the engine-only gate; None where there is none)."""
    return dict(trajs=trajs, metrics=metrics or {}, analytic_ok=analytic_ok)


def _zero_tau(t, s):
    return np.zeros((1, 0))


# ---------------------------------------------------------------------------
# box experiments
# ---------------------------------------------------------------------------


def _box():
    return box(half_extents=(0.1, 0.1, 0.05), mass=1.0)


def box_setup(mu, theta=0.0, z0=0.05, v0=(0.0, 0.0, 0.0), e=0.0,
              device="cuda"):
    dev = _device(device)
    model = _box()
    G = 9.81
    gvec = np.array([G * np.sin(theta), 0.0, -G * np.cos(theta)])
    N = 1
    f32 = dict(dtype=torch.float32, device=dev)
    dyn = E.DynamicsParams(
        payload=torch.zeros(N, **f32),
        com_displacement=torch.zeros((N, 3), **f32),
        friction=torch.full((N,), 2 * mu - 1.0, **f32),
        restitution=torch.full((N,), e, **f32),
        gravity=torch.as_tensor(gvec, **f32)[None])
    state = E.PhysicsState(
        base_pos=torch.tensor([[0.0, 0.0, z0]], **f32),
        base_quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]], **f32),
        base_lin_vel=torch.tensor([v0], **f32),
        base_ang_vel=torch.zeros((N, 3), **f32),
        q=torch.zeros((N, 0), **f32), qd=torch.zeros((N, 0), **f32))
    return model, dyn, state, gvec


SLIDE = dict(MU=0.5, DT=0.005, STEPS=120, V0=2.0)


def engine_box_slide(device="cuda"):
    MU, DT, STEPS, V0 = (SLIDE[k] for k in ("MU", "DT", "STEPS", "V0"))
    model, dyn, state, gvec = box_setup(MU, v0=(V0, 0.0, 0.0), device=device)
    params = E.SimParams(dt=DT, use_pallas_contact=False)
    _, ours = _engine_sim(model, params, state, _zero_tau, dyn, STEPS, DT)
    t = (np.arange(STEPS) + 1) * DT
    v_ours = np.array([r[2][0] for r in ours])
    v_ana = np.maximum(V0 - MU * 9.81 * t, 0.0)
    # compare only while sliding (analytic stop at 0.408 s)
    sl = t < (V0 / (MU * 9.81)) * 0.9
    err_ours = float(np.abs(v_ours[sl] - v_ana[sl]).max())
    return _half({"run": ours}, dict(max_err_vs_analytic_ours=err_ours,
                                  v_final_ours=float(v_ours[-1])),
                 err_ours < 0.03)


def run_box_slide(out, device="cuda"):
    """Kinetic friction on flat ground: v0 = 2 m/s, mu = 0.5 ->
    deceleration mu*g until stop; compare v(t) ours vs MuJoCo vs analytic."""
    MU, DT, STEPS, V0 = (SLIDE[k] for k in ("MU", "DT", "STEPS", "V0"))
    eng = engine_box_slide(device)
    ours = eng["trajs"]["run"]
    model = _box()
    xml = mjcf.go1_mjcf(model, mu=MU, timestep=MJ_DT,
                        gravity=(0.0, 0.0, -9.81))
    st0 = (np.array([0.0, 0.0, 0.05]), np.array([0.0, 0.0, 0.0, 1.0]),
           np.array([V0, 0.0, 0.0]), np.zeros(3), np.zeros(0), np.zeros(0))
    mj = _mj_sim(xml, st0, _zero_tau, STEPS, DT)

    t = (np.arange(STEPS) + 1) * DT
    v_ours = np.array([r[2][0] for r in ours])
    v_mj = np.array([r[2][0] for r in mj])
    v_ana = np.maximum(V0 - MU * 9.81 * t, 0.0)
    sl = t < (V0 / (MU * 9.81)) * 0.9
    err_ours = eng["metrics"]["max_err_vs_analytic_ours"]
    err_mj = float(np.abs(v_mj[sl] - v_ana[sl]).max())
    err_x = float(np.abs(v_ours[sl] - v_mj[sl]).max())
    res = dict(experiment="box-slide", mu=MU, v0=V0,
               max_err_vs_analytic_ours=err_ours,
               max_err_vs_analytic_mujoco=err_mj,
               max_err_ours_vs_mujoco=err_x,
               v_final_ours=float(v_ours[-1]), v_final_mj=float(v_mj[-1]))
    ok = err_ours < 0.03 and err_x < 0.05
    _report(out, res, ok)
    return ok


INCLINE = dict(MU=0.4, DT=0.005, STEPS=200)


def _incline_cases():
    crit = np.arctan(INCLINE["MU"])
    return (("below", crit - np.deg2rad(4.0)),
            ("above", crit + np.deg2rad(8.0)))


def engine_box_incline(device="cuda"):
    MU, DT, STEPS = (INCLINE[k] for k in ("MU", "DT", "STEPS"))
    trajs, metrics, ok = {}, {}, True
    for name, theta in _incline_cases():
        model, dyn, state, gvec = box_setup(MU, theta=theta, device=device)
        params = E.SimParams(dt=DT, use_pallas_contact=False)
        _, trajs[name] = _engine_sim(model, params, state, _zero_tau, dyn,
                                     STEPS, DT)
        t = (np.arange(STEPS) + 1) * DT
        vx_o = np.array([r[2][0] for r in trajs[name]])
        w = t > 0.5
        a_o = np.polyfit(t[w], vx_o[w], 1)[0]
        a_ana = max(9.81 * (np.sin(theta) - MU * np.cos(theta)), 0.0)
        metrics[name] = dict(accel_ours=float(a_o),
                             accel_analytic=float(a_ana))
        if name == "below":
            ok &= abs(a_o) < 0.02
        else:
            ok &= abs(a_o - a_ana) < 0.05
    return _half(trajs, metrics, bool(ok))


def run_box_incline(out, device="cuda"):
    """Stick below arctan(mu); above it slide with accel g(sin-mu cos)."""
    MU, DT, STEPS = (INCLINE[k] for k in ("MU", "DT", "STEPS"))
    eng = engine_box_incline(device)
    results = []
    ok = True
    for name, theta in _incline_cases():
        model, _, _, gvec = box_setup(MU, theta=theta, device="cpu")
        ours = eng["trajs"][name]
        xml = mjcf.go1_mjcf(model, mu=MU, timestep=MJ_DT, gravity=tuple(gvec))
        st0 = (np.array([0.0, 0.0, 0.05]), np.array([0.0, 0.0, 0.0, 1.0]),
               np.zeros(3), np.zeros(3), np.zeros(0), np.zeros(0))
        mj = _mj_sim(xml, st0, _zero_tau, STEPS, DT)
        t = (np.arange(STEPS) + 1) * DT
        vx_o = np.array([r[2][0] for r in ours])
        vx_m = np.array([r[2][0] for r in mj])
        w = t > 0.5
        a_o = np.polyfit(t[w], vx_o[w], 1)[0]
        a_m = np.polyfit(t[w], vx_m[w], 1)[0]
        a_ana = max(9.81 * (np.sin(theta) - MU * np.cos(theta)), 0.0)
        results.append(dict(case=name, theta_deg=float(np.rad2deg(theta)),
                            accel_ours=float(a_o), accel_mujoco=float(a_m),
                            accel_analytic=float(a_ana)))
        if name == "below":
            ok &= abs(a_o) < 0.02 and abs(a_m) < 0.02
        else:
            ok &= abs(a_o - a_ana) < 0.05 and abs(a_o - a_m) < 0.08
    res = dict(experiment="box-incline", mu=MU, cases=results)
    _report(out, res, ok)
    return ok


REST = dict(DT=0.005, STEPS=300)


def engine_box_rest(device="cuda"):
    DT, STEPS = REST["DT"], REST["STEPS"]
    model, dyn, state, _ = box_setup(0.8, z0=0.06, device=device)
    params = E.SimParams(dt=DT, use_pallas_contact=False)
    st, ours = _engine_sim(model, params, state, _zero_tau, dyn, STEPS, DT)
    z_o = float(_host(st.base_pos[0, 2]))
    pen_o = 0.05 - z_o
    return _half({"run": ours}, dict(rest_height_ours=z_o,
                                  penetration_ours=pen_o,
                                  contact_slop=params.contact_slop),
                 abs(pen_o) < params.contact_slop + 1e-3)


def run_box_rest(out, device="cuda"):
    """Resting penetration: ours should settle within contact_slop (2 mm);
    MuJoCo's soft contact settles at its own solimp scale."""
    DT, STEPS = REST["DT"], REST["STEPS"]
    eng = engine_box_rest(device)
    model = _box()
    params = E.SimParams(dt=DT, use_pallas_contact=False)
    z_o = eng["metrics"]["rest_height_ours"]
    xml = mjcf.go1_mjcf(model, mu=0.8, timestep=MJ_DT)
    st0 = (np.array([0.0, 0.0, 0.06]), np.array([0.0, 0.0, 0.0, 1.0]),
           np.zeros(3), np.zeros(3), np.zeros(0), np.zeros(0))
    mj = _mj_sim(xml, st0, _zero_tau, STEPS, DT)
    z_m = float(mj[-1][0][2])
    pen_o = 0.05 - z_o
    pen_m = 0.05 - z_m
    res = dict(experiment="box-rest", rest_height_ours=z_o,
               rest_height_mujoco=z_m, penetration_ours=pen_o,
               penetration_mujoco=pen_m, contact_slop=params.contact_slop)
    ok = abs(pen_o) < params.contact_slop + 1e-3
    _report(out, res, ok)
    return ok


BOUNCE = dict(DT=0.0025, STEPS=800, E_R=0.5, H0=0.3)


def engine_box_bounce(device="cuda"):
    DT, STEPS, E_R, H0 = (BOUNCE[k] for k in ("DT", "STEPS", "E_R", "H0"))
    model, dyn, state, _ = box_setup(0.8, z0=0.05 + H0, e=E_R, device=device)
    params = E.SimParams(dt=DT, use_pallas_contact=False)
    _, ours = _engine_sim(model, params, state, _zero_tau, dyn, STEPS, DT)
    z = np.array([r[0][2] for r in ours])
    # first rebound apex after the first impact
    imp = np.argmax(z < 0.051)
    apex = float(z[imp:].max() - 0.05)
    ratio = apex / H0
    # velocity-level restitution at finite dt underestimates the apex by
    # up to one substep of gravity; accept 20% relative
    return _half({"run": ours}, dict(rebound_apex=apex, measured_ratio=ratio,
                                  analytic_ratio=E_R * E_R),
                 abs(ratio - E_R * E_R) < 0.2 * E_R * E_R + 0.02)


def run_box_bounce(out, device="cuda"):
    """Restitution: drop from h0 with e = 0.5 -> rebound apex ~ e^2 h0.
    Engine-only vs analytic (MuJoCo has no restitution coefficient --
    its solref model is a damped spring, documented here)."""
    E_R, H0 = BOUNCE["E_R"], BOUNCE["H0"]
    eng = engine_box_bounce(device)
    m = eng["metrics"]
    res = dict(experiment="box-bounce", e=E_R, drop_height=H0,
               rebound_apex=m["rebound_apex"],
               measured_ratio=m["measured_ratio"],
               analytic_ratio=E_R * E_R,
               note="MuJoCo ships no restitution coefficient; engine-only "
                    "check vs analytic e^2 h0")
    ok = eng["analytic_ok"]
    _report(out, res, ok)
    return ok


# ---------------------------------------------------------------------------
# go1 experiments
# ---------------------------------------------------------------------------


def _go1_init(z0=0.32, device="cuda"):
    dev = _device(device)
    model = go1()
    ddp = _host(default_dof_pos(model, dict(GO1_DEFAULT_JOINT_ANGLES),
                                device=dev))
    N = 1
    f32 = dict(dtype=torch.float32, device=dev)
    dyn = E.identity_dynamics_params(N, device=dev)
    state = E.PhysicsState(
        base_pos=torch.tensor([[0.0, 0.0, z0]], **f32),
        base_quat=torch.tensor([[0.0, 0.0, 0.0, 1.0]], **f32),
        base_lin_vel=torch.zeros((N, 3), **f32),
        base_ang_vel=torch.zeros((N, 3), **f32),
        q=torch.as_tensor(ddp, **f32)[None], qd=torch.zeros((N, 12), **f32))
    return model, dyn, state, ddp


def _q_qd(st):
    """Env 0's joint positions and velocities on the host, one copy."""
    x = _host(torch.cat([st.q[0], st.qd[0]]))
    return x[:12], x[12:]


def _go1_st0(ddp):
    return (np.array([0.0, 0.0, 0.32]), np.array([0.0, 0.0, 0.0, 1.0]),
            np.zeros(3), np.zeros(3), ddp.copy(), np.zeros(12))


STANDING = dict(DT=0.005, STEPS=400, kp=40.0, kd=1.0)


def engine_go1_standing(device="cuda"):
    DT, STEPS, kp, kd = (STANDING[k] for k in ("DT", "STEPS", "kp", "kd"))
    model, dyn, state, ddp = _go1_init(device=device)
    params = E.SimParams(dt=DT, use_pallas_contact=False)
    lim = np.asarray(model.dof_effort)

    def tau_ours(t, st):
        q, qd = _q_qd(st)
        return np.clip(kp * (ddp - q) - kd * qd, -lim, lim)[None]

    st, ours = _engine_sim(model, params, state, tau_ours, dyn, STEPS, DT)
    fz_ours = float(np.asarray(ours[-1][6])[:, 2].sum())
    z_ours = float(ours[-1][0][2])
    weight = float(np.sum(model.mass) * 9.81)
    return _half({"run": ours}, dict(weight=weight, fz_ours=fz_ours,
                                  stand_height_ours=z_ours),
                 abs(fz_ours - weight) / weight < 0.05)


def run_go1_standing(out, device="cuda"):
    """Steady standing under a constant default-pose PD hold: total normal
    force == weight in both engines; base settles at a similar height."""
    DT, STEPS, kp, kd = (STANDING[k] for k in ("DT", "STEPS", "kp", "kd"))
    eng = engine_go1_standing(device)
    model = go1()
    ddp = _host(default_dof_pos(model, dict(GO1_DEFAULT_JOINT_ANGLES),
                                device="cpu"))
    lim = np.asarray(model.dof_effort)
    fz_ours = eng["metrics"]["fz_ours"]
    z_ours = eng["metrics"]["stand_height_ours"]

    xml = mjcf.go1_mjcf(model, mu=1.0, timestep=MJ_DT)
    st0 = _go1_st0(ddp)

    # closed-loop PD inside MuJoCo needs its own state: use a stateful fn
    import mujoco
    mjm = mujoco.MjModel.from_xml_string(xml)
    mjd = mujoco.MjData(mjm)
    mjcf.set_mj_state(mjd, *st0)
    mujoco.mj_forward(mjm, mjd)
    for t in range(int(STEPS * DT / MJ_DT)):
        q = np.array(mjd.qpos[7:])
        qd = np.array(mjd.qvel[6:])
        mjd.ctrl[:] = np.clip(kp * (ddp - q) - kd * qd, -lim, lim)
        mujoco.mj_step(mjm, mjd)
    fz_mj = 0.0
    for c in range(mjd.ncon):
        f6 = np.zeros(6)
        mujoco.mj_contactForce(mjm, mjd, c, f6)
        R = mjd.contact[c].frame.reshape(3, 3)
        fz_mj += (R.T @ f6[:3])[2]
    z_mj = float(mjd.qpos[2])

    weight = float(np.sum(model.mass) * 9.81)
    res = dict(experiment="go1-standing", weight=weight,
               fz_ours=fz_ours, fz_mujoco=float(fz_mj),
               stand_height_ours=z_ours, stand_height_mujoco=z_mj)
    ok = (abs(fz_ours - weight) / weight < 0.05
          and abs(fz_mj - weight) / weight < 0.05
          and abs(z_ours - z_mj) < 0.03)
    _report(out, res, ok)
    return ok


# the closed-loop dance of both replays: a moderate bodyweight-shifting
# dance probes stance contact forces and load transfer without approaching
# tip-over (tip-over onset is chaotic, where ANY two correct engines
# diverge qualitatively)
REPLAY = dict(DT=0.005, STEPS=400, kp=20.0, kd=0.5)
REPLAY_MODES = (("exact", False, 1), ("exact50", False, 4),
                ("reuse", True, 4))


def _dance(ddp):
    DT = REPLAY["DT"]
    amp = np.array([0.06, 0.15, 0.15] * 4)
    phases = np.arange(12) * 0.7

    def target(t):
        return ddp + amp * np.sin(2 * np.pi * 1.0 * t * DT + phases)
    return target


def _hold4(fn):
    cache = {}

    def wrapped(t, st):
        if t % 4 == 0:
            cache["tau"] = fn(t, st)
        return cache["tau"]
    return wrapped


def engine_go1_replay(device="cuda"):
    DT, STEPS, kp, kd = (REPLAY[k] for k in ("DT", "STEPS", "kp", "kd"))
    model, dyn, state, ddp = _go1_init(device=device)
    lim = np.asarray(model.dof_effort)
    target = _dance(ddp)

    def tau_ours(t, st):
        q, qd = _q_qd(st)
        return np.clip(kp * (target(t) - q) - kd * qd, -lim, lim)[None]

    trajs = {}
    for mode, reuse, rate in REPLAY_MODES:
        params = E.SimParams(dt=DT, use_pallas_contact=False)
        fn = tau_ours if rate == 1 or reuse else _hold4(tau_ours)
        _, trajs[mode] = _engine_sim(model, params, state, fn, dyn, STEPS,
                                     DT, reuse=reuse)
    return _half(trajs)


def run_go1_replay(out, device="cuda"):
    """Closed-loop PD replay: both engines run the SAME 200 Hz PD law
    toward the same sinusoidal joint-target schedule (within limits) from
    identical initial states, and the resulting base/joint trajectories
    are compared over 2 s.  Open-loop torque replay is NOT used: contact-
    rich dynamics are chaotic, so identical torques diverge exponentially
    in ANY pair of correct engines; the closed-loop protocol keeps both
    on the task attractor and measures solver-level agreement.  Run for
    the exact, exact50 and reuse solver modes to also quantify the
    approximation cost of matrix reuse."""
    DT, STEPS, kp, kd = (REPLAY[k] for k in ("DT", "STEPS", "kp", "kd"))
    eng = engine_go1_replay(device)
    model = go1()
    ddp = _host(default_dof_pos(model, dict(GO1_DEFAULT_JOINT_ANGLES),
                                device="cpu"))
    lim = np.asarray(model.dof_effort)
    target = _dance(ddp)

    def tau_mj(t, mj_state):
        q, qd = mj_state[4], mj_state[5]
        return np.clip(kp * (target(t) - q) - kd * qd, -lim, lim)[None]

    xml = mjcf.go1_mjcf(model, mu=1.0, timestep=MJ_DT)
    st0 = _go1_st0(ddp)

    res = dict(experiment="go1-replay", horizon_s=STEPS * DT, modes={})
    # exact mode runs PD at 200 Hz (every substep); reuse mode applies one
    # torque per 4-substep control step, so its MuJoCo counterpart holds
    # torques for 4 steps too (fair comparison at 50 Hz).  exact50
    # isolates the control-rate effect: same exact solver, same 50 Hz
    # torque hold as reuse mode — the reuse-vs-exact50 gap is then
    # attributable to the matrix-reuse approximation alone
    mj_by_rate = {}   # the MuJoCo side depends only on the hold rate —
    # reuse one rollout per rate across modes and the chaos floor below

    def mj_at(rate):
        if rate not in mj_by_rate:
            mj_by_rate[rate] = _mj_sim(xml, st0, tau_mj, STEPS, DT,
                                       hold=rate)
        return mj_by_rate[rate]

    for mode, reuse, rate in REPLAY_MODES:
        ours = eng["trajs"][mode]
        stride = 4 if reuse else 1
        mj = mj_at(rate)
        pos_mj = np.array([r[0] for r in mj])
        quat_mj = np.array([r[1] for r in mj])
        q_mj = np.array([r[4] for r in mj])
        pos_o = np.array([r[0] for r in ours])
        quat_o = np.array([r[1] for r in ours])
        q_o = np.array([r[4] for r in ours])
        p_m = pos_mj[stride - 1::stride][:len(pos_o)]
        qu_m = quat_mj[stride - 1::stride][:len(pos_o)]
        q_m = q_mj[stride - 1::stride][:len(q_o)]
        res["modes"][mode] = _traj_metrics(pos_o, quat_o, q_o,
                                           p_m, qu_m, q_m)
    # -- chaos floor: how far does MuJoCo diverge from ITSELF over this
    # horizon under the same 50 Hz hold, when (a) the initial joint
    # velocities are perturbed by 1e-6, and (b) the micro-timestep is
    # halved?  Contact-rich closed-loop dynamics are chaotic, so this
    # intra-oracle spread is the floor below which cross-engine divergence
    # is indistinguishable from numerical noise — the exact50/reuse numbers
    # above must be read against it, not against zero.
    def _mj_pair_metrics(a, b):
        return _traj_metrics(
            np.array([r[0] for r in a]), np.array([r[1] for r in a]),
            np.array([r[4] for r in a]),
            np.array([r[0] for r in b]), np.array([r[1] for r in b]),
            np.array([r[4] for r in b]))

    mj_ref = mj_at(4)
    st0_pert = (st0[0], st0[1], st0[2], st0[3], st0[4],
                st0[5] + 1e-6 * np.arange(1, 13))
    mj_pert = _mj_sim(xml, st0_pert, tau_mj, STEPS, DT, hold=4)
    xml_half = mjcf.go1_mjcf(model, mu=1.0, timestep=MJ_DT / 2)
    mj_half = _mj_sim(xml_half, st0, tau_mj, STEPS, DT, hold=4)
    res["mj_selfdiv"] = dict(
        perturb_qd_1e6=_mj_pair_metrics(mj_ref, mj_pert),
        halved_timestep=_mj_pair_metrics(mj_ref, mj_half),
        note="MuJoCo-vs-MuJoCo divergence under the 50 Hz hold; the "
             "chaos floor for reading the exact50/reuse cross-engine "
             "numbers")

    exact_m = res["modes"]["exact"]
    reuse_m = res["modes"]["reuse"]
    e50_m = res["modes"]["exact50"]
    # gates: xy position is a random-walk integral of stance micro-slip
    # and is reported but not gated; height, tilt, and joint tracking are
    # the solver-level quantities (the JAX package's measured values with
    # ~2x margin, runs/mujoco_parity)
    ok = (exact_m["base_z_rmse"] < 0.03 and exact_m["base_z_max"] < 0.10
          and exact_m["tilt_diff_max_deg"] < 12.0
          and exact_m["joint_rmse"] < 0.20)
    ok &= (reuse_m["base_z_rmse"] < 2.5 * e50_m["base_z_rmse"] + 0.015
           and reuse_m["joint_rmse"] < 2.5 * e50_m["joint_rmse"] + 0.03)
    _report(out, res, ok)
    return ok


ACTUATOR = dict(DT=0.005, STEPS=400, LAG=6)


def _host_actuator_net():
    """Numpy forward of the converted actuator net, pinned to the port's
    models/actuator_net.apply (the training path) so the two cannot
    drift."""
    z = np.load(anet._DEFAULT_PATH)
    w0, b0, w1, b1, w2, b2 = (z[k] for k in ("w0", "b0", "w1", "b1",
                                             "w2", "b2"))

    def net(x):  # (12, 6) -> (12,)
        s = lambda v: v / (1.0 + np.abs(v))
        h = s(x @ w0.T + b0)
        h = s(h @ w1.T + b1)
        return (h @ w2.T + b2)[:, 0]

    probe = np.random.RandomState(0).uniform(-1, 1, (12, 6)).astype(
        np.float32)
    with torch.no_grad():
        want = anet.apply(anet.load(device="cpu"), torch.from_numpy(probe))
    assert np.allclose(net(probe), want.numpy(), atol=1e-5), \
        "host-side actuator net drifted"
    return net


def _actuator_law(net, ddp, lim, get_qqd):
    """Stateful torque law mirroring the shipping substep pipeline
    (go1_env._compute_torques / reference legged_robot.py:907-918): the
    lag buffer shifts EVERY 5 ms substep and is fed the CURRENT control
    step's target (held constant across its 4 substeps, like the action
    is), so lag_timesteps=6 means a 6-substep (30 ms) delay; the net's
    error/velocity histories are 2-deep and also advance per substep."""
    LAG = ACTUATOR["LAG"]
    target = _dance(ddp)
    st = dict(lag=[ddp.copy()] * (LAG + 1),
              el=np.zeros(12), ell=np.zeros(12),
              vl=np.zeros(12), vll=np.zeros(12))

    def law(t, engine_state):
        q, qd = get_qqd(engine_state)
        st["lag"] = st["lag"][1:] + [target(t - (t % 4))]
        err = q - st["lag"][0]
        x = np.stack([err, st["el"], st["ell"],
                      qd, st["vl"], st["vll"]], axis=-1)
        tau = np.clip(net(x), -lim, lim)
        st["ell"], st["el"] = st["el"], err
        st["vll"], st["vl"] = st["vl"], qd
        return tau[None]
    return law


def engine_go1_replay_actuator(device="cuda"):
    DT, STEPS = ACTUATOR["DT"], ACTUATOR["STEPS"]
    model, dyn, state, ddp = _go1_init(device=device)
    lim = np.asarray(model.dof_effort)
    params = E.SimParams(dt=DT, use_pallas_contact=False)
    law_ours = _actuator_law(_host_actuator_net(), ddp, lim, _q_qd)
    _, ours = _engine_sim(model, params, state, law_ours, dyn, STEPS, DT)
    return _half({"run": ours})


def run_go1_replay_actuator(out, device="cuda"):
    """Closed-loop replay through the LEARNED MOTOR MODEL: both engines run
    the same joint-target dance, but torques come from the converted
    reference actuator network fed through the 6-control-step lag buffer —
    the shipping MoB torque path (reference legged_robot.py:907-918 lag
    shift, :930-938 net eval, play config lag_timesteps=6) — instead of
    plain PD.  Each engine keeps its OWN error/velocity histories (the net
    is stateful), evaluated per 5 ms substep like the env does."""
    DT, STEPS, LAG = (ACTUATOR[k] for k in ("DT", "STEPS", "LAG"))
    eng = engine_go1_replay_actuator(device)
    ours = eng["trajs"]["run"]
    model = go1()
    ddp = _host(default_dof_pos(model, dict(GO1_DEFAULT_JOINT_ANGLES),
                                device="cpu"))
    lim = np.asarray(model.dof_effort)
    xml = mjcf.go1_mjcf(model, mu=1.0, timestep=MJ_DT)
    law_mj = _actuator_law(_host_actuator_net(), ddp, lim,
                           lambda s: (s[4], s[5]))
    mj = _mj_sim(xml, _go1_st0(ddp), law_mj, STEPS, DT, hold=1)

    pos_o = np.array([r[0] for r in ours]); pos_m = np.array([r[0] for r in mj])
    qu_o = np.array([r[1] for r in ours]); qu_m = np.array([r[1] for r in mj])
    q_o = np.array([r[4] for r in ours]); q_m = np.array([r[4] for r in mj])
    res = dict(experiment="go1-replay-actuator", horizon_s=STEPS * DT,
               lag_substeps=LAG,
               **_traj_metrics(pos_o, qu_o, q_o, pos_m, qu_m, q_m),
               final_z_ours=float(pos_o[-1, 2]),
               final_z_mj=float(pos_m[-1, 2]))
    # gates mirror the exact-mode PD replay's (measured values + ~2x)
    ok = (res["base_z_rmse"] < 0.03 and res["base_z_max"] < 0.10
          and res["tilt_diff_max_deg"] < 12.0 and res["joint_rmse"] < 0.20)
    _report(out, res, ok)
    return ok


def _report(out, res, ok):
    res["pass"] = bool(ok)
    name = res["experiment"]
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(res, f, indent=1)
    line = {k: v for k, v in res.items() if not isinstance(v, (dict, list))}
    print(("PASS " if ok else "FAIL ") + json.dumps(line), flush=True)


EXPERIMENTS = dict(
    box_slide=run_box_slide, box_incline=run_box_incline,
    box_rest=run_box_rest, box_bounce=run_box_bounce,
    go1_standing=run_go1_standing, go1_replay=run_go1_replay,
    go1_replay_actuator=run_go1_replay_actuator)
# each experiment's constants (its substep dt among them)
SETUPS = dict(
    box_slide=SLIDE, box_incline=INCLINE, box_rest=REST, box_bounce=BOUNCE,
    go1_standing=STANDING, go1_replay=REPLAY, go1_replay_actuator=ACTUATOR)
ENGINE_HALVES = dict(
    box_slide=engine_box_slide, box_incline=engine_box_incline,
    box_rest=engine_box_rest, box_bounce=engine_box_bounce,
    go1_standing=engine_go1_standing, go1_replay=engine_go1_replay,
    go1_replay_actuator=engine_go1_replay_actuator)


ROW_FIELDS = ("pos", "quat", "lin", "ang", "q", "qd", "report_forces")


def engine_only(out, device, names):
    """The engine halves of `names` without MuJoCo: a PASS/FAIL line each
    (seconds, engine-only metrics, `analytic_ok`: FAIL only where an
    engine-only gate fails) and `<out>/<name>.engine.npz` ("<mode>/<field>"
    arrays of the trajectory rows).  Returns {name: analytic_ok}."""
    dev = _device(device)
    os.makedirs(out, exist_ok=True)
    results = {}
    for name in names:
        t0 = time.time()
        half = ENGINE_HALVES[name](dev)
        seconds = time.time() - t0      # every row was copied to the host
        np.savez(os.path.join(out, f"{name}.engine.npz"), **{
            f"{mode}/{field}": np.stack([r[i] for r in traj])
            for mode, traj in half["trajs"].items()
            for i, field in enumerate(ROW_FIELDS)})
        results[name] = half["analytic_ok"]
        line = dict(experiment=name, device=str(dev), seconds=seconds,
                    rows={m: len(t) for m, t in half["trajs"].items()},
                    analytic_ok=half["analytic_ok"], **half["metrics"])
        print(("FAIL " if half["analytic_ok"] is False else "PASS ")
              + json.dumps(line), flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="runs/mujoco_parity_torch")
    ap.add_argument("--only", default=None, choices=sorted(EXPERIMENTS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--engine-only", action="store_true")
    a = ap.parse_args(argv)
    _device(a.device)
    if a.device == "cpu":
        # N = 1: thousands of tiny ops a substep, fastest on one thread
        torch.set_num_threads(1)
    names = [a.only] if a.only else list(EXPERIMENTS)
    if a.engine_only:
        results = engine_only(a.out, a.device, names)
        print(json.dumps(results))
        return 0 if all(v is not False for v in results.values()) else 1
    results = {name: bool(EXPERIMENTS[name](a.out, a.device))
               for name in names}
    print(json.dumps(results))
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
