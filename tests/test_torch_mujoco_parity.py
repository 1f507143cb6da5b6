"""The port's MuJoCo cross-check (scripts/mujoco_parity.py) on the CPU.

First the port's dense engine on `box()` against the JAX package's, substep
by substep: `box()` is no star of 3-dof chains, so this is the dense
route's `torch.linalg.inv` branch of `_mass_matrix_inverse`.  Then the
port's experiments against MuJoCo at the JAX script's gates.  The JAX
package's own study is committed in runs/mujoco_parity/.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from walk_these_ways_tpu.models import robot as j_robot
from walk_these_ways_tpu.physics import engine as JE

from walk_these_ways_tpu_torch.physics import engine as TE
from walk_these_ways_tpu_torch.scripts import mujoco_parity as mp

from test_torch_util import assert_close

torch.set_num_threads(1)

# (mu, theta, z0, v0, e) at the slide's 5 ms substep: the slide as the
# experiment starts it, and the bounce one substep before its impact at the
# drop's speed, so that the restitution target is taken within the 10
# substeps
DT = 0.005
BOX_CASES = {
    "slide": (0.5, 0.0, 0.05, (2.0, 0.0, 0.0), 0.0),
    "bounce": (0.8, 0.0, 0.0512,
               (0.0, 0.0, -float(np.sqrt(2 * 9.81 * 0.3))), 0.5),
}


@pytest.fixture(scope="module")
def jax_box_step():
    """The JAX package's `physics_substep` on `box()`, jitted once: state
    and dynamics parameters traced."""
    model = j_robot.box(half_extents=(0.1, 0.1, 0.05), mass=1.0)
    params = JE.SimParams(dt=DT, use_pallas_contact=False)
    return jax.jit(lambda s, dyn: JE.physics_substep(
        model, params, s, jnp.zeros((1, 0)), dyn, JE.flat_terrain()))


@pytest.mark.parametrize("case", sorted(BOX_CASES))
def test_box_dense_engine_matches_jax_for_10_substeps(jax_box_step, case):
    mu, theta, z0, v0, e = BOX_CASES[case]
    dt = DT
    model_t, dyn_t, st_t, gvec = mp.box_setup(mu, theta=theta, z0=z0, v0=v0,
                                              e=e, device="cpu")
    assert TE._tables(model_t, torch.device("cpu")).chains is None
    dyn_j = JE.DynamicsParams(*[jnp.asarray(x.numpy()) for x in dyn_t])
    st_j = JE.PhysicsState(*[jnp.asarray(x.numpy()) for x in st_t])
    params_t = TE.SimParams(dt=dt, use_pallas_contact=False)
    terrain = TE.flat_terrain("cpu")
    contact = False
    for k in range(10):
        st_j, info_j = jax_box_step(st_j, dyn_j)
        st_t, info_t = TE.physics_substep(model_t, params_t, st_t,
                                          torch.zeros((1, 0)), dyn_t,
                                          terrain)
        for name, a, b in zip(st_t._fields, st_t, st_j):
            assert_close(a, b, err_msg=f"substep {k} {name}")
        # the solver's output is the impulse; a force is impulse / dt, so
        # its components that are zero up to rounding carry |F| * 1e-7 / dt
        # (measured 2.7e-6 N at 1477 N): held as impulses, F * dt
        assert_close(info_t.report_forces * dt,
                     np.asarray(info_j.report_forces) * dt,
                     err_msg=f"substep {k} report impulses")
        contact |= bool(np.abs(np.asarray(info_j.report_forces)).max() > 0)
    assert contact


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mujoco_parity_torch"))


@pytest.fixture(scope="module")
def mujoco():
    return pytest.importorskip("mujoco")


def test_box_slide_kinetic_friction(out, mujoco):
    """Slide deceleration == mu*g: ours within one-substep discretization
    of analytic AND within 0.05 m/s of MuJoCo pointwise."""
    assert mp.run_box_slide(out, "cpu")


def test_box_incline_stick_slip(out, mujoco):
    """Stick below arctan(mu); above it, slide accel g(sin-mu cos) within
    0.05 m/s^2 of analytic and 0.08 of MuJoCo."""
    assert mp.run_box_incline(out, "cpu")


def test_box_rest_penetration(out, mujoco):
    """Resting penetration within contact_slop (2 mm) + 1 mm."""
    assert mp.run_box_rest(out, "cpu")


def test_box_bounce_restitution(out):
    """Rebound apex e^2 h0 within 20% + 0.02 (engine vs analytic; MuJoCo
    ships no restitution coefficient), through the entry point on the
    CPU."""
    assert mp.main(["--device", "cpu", "--only", "box_bounce",
                    "--out", out]) == 0
    with open(os.path.join(out, "box-bounce.json")) as f:
        res = json.load(f)
    assert res["pass"] and abs(res["measured_ratio"] - 0.25) < 0.07


def test_go1_standing_forces(out, mujoco):
    """Steady standing: total normal force == weight within 5% in BOTH
    engines; stand height within 3 cm of MuJoCo."""
    assert mp.run_go1_standing(out, "cpu")


def test_go1_closed_loop_replay(out, mujoco):
    """2 s closed-loop PD dance: exact mode within mm/deg-scale of MuJoCo;
    matrix-reuse mode no worse than the same-control-rate exact run."""
    assert mp.run_go1_replay(out, "cpu")


def test_go1_replay_through_actuator_net(out, mujoco):
    """2 s dance with torques from the actuator network + the per-substep
    6-deep lag buffer in both engines."""
    assert mp.run_go1_replay_actuator(out, "cpu")


def test_engine_only_writes_the_engine_half(tmp_path, capsys):
    """`--engine-only` (the card's machine has no MuJoCo): the engine half's
    trajectory rows in `<name>.engine.npz` (the slide's 120 substeps, the
    velocity its line reports last), its engine-only gate in the line and
    the return code."""
    assert mp.main(["--device", "cpu", "--engine-only", "--only",
                    "box_slide", "--out", str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[0][5:])
    assert line["analytic_ok"] is True and line["rows"] == {"run": 120}
    z = np.load(tmp_path / "box_slide.engine.npz")
    assert sorted(z.files) == sorted(f"run/{f}" for f in mp.ROW_FIELDS)
    assert z["run/pos"].shape == (120, 3) and z["run/q"].shape == (120, 0)
    assert float(z["run/lin"][-1, 0]) == line["v_final_ours"]
    assert float(z["run/lin"][:, 0].min()) < 0.1        # it stopped
    assert z["run/report_forces"].shape == (120, 1, 3)


def test_entry_point_needs_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                          tmp_path):
    """`--device` defaults to cuda and raises without it, before any
    experiment runs (test_box_bounce_restitution and
    test_engine_only_writes_the_engine_half run it with `--device cpu`)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda", "--only", "box_slide"],
                 ["--engine-only"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            mp.main(argv + ["--out", str(tmp_path)])
    assert not any(tmp_path.iterdir())
