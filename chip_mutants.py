#!/usr/bin/env python3
"""Mutation check of `chip_smoke.py` on one NVIDIA GPU.

    python3 chip_mutants.py [name ...]

For each mutant below (or each one named): copies `chip_smoke.py`, the port's package and
`resources/` into `build/mutants/<name>/`, makes ONE edit in one kernel
source there, runs `python3 chip_smoke.py` in the copy and records its exit
code and the first check that failed.  The smoke test must exit non-zero on
every mutant, and at the check named here; kernels that the edit does not
reach must still pass before it.  Prints one JSON line per mutant and a last
line `{"ok": ..., "mutants": n}`; exits non-zero if a mutant survived.

The working tree is never edited.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join("walk_these_ways_tpu_torch", "csrc")
# (name, source, text to replace, replacement, the check that must fail)
MUTANTS = (
    # the one-thread kernels' dynamics (K3 is the first checked that runs
    # them; K4 runs the team kernel's own, next)
    ("shared_dynamics_bias_sign", "wtw_device.cuh",
     "tb[6 + j] = tau[6 + j] - acc;", "tb[6 + j] = tau[6 + j] + acc;",
     "dynamics_substep"),
    ("team_dynamics_bias_sign", "megastep_team.cu",
     "s.x[lane] = s.tau[lane] - acc;", "s.x[lane] = s.tau[lane] + acc;",
     "control_step"),
    # the team kernel's sum of the points' J^T dlam rows into the dof slots
    # reads one slot past a point's leg columns (the next point's row)
    ("team_dof_sum_reads_past_the_points_columns", "megastep_team.cu",
     "if (k >= 0 && k < MS_PT_N[p]) acc += s.u.jt[p][6 + k];",
     "if (k >= 0 && k <= MS_PT_N[p]) acc += s.u.jt[p][6 + k];",
     "control_step"),
    # the in-kernel heightfield sample (K4b) tilts the normal the wrong way
    # along x
    ("heightfield_sample_slope_sign", "wtw_device.cuh",
     "const float nx = -dhdx, ny = -dhdy, nz = 1.0f;",
     "const float nx = dhdx, ny = -dhdy, nz = 1.0f;",
     "control_step_normals"),
    ("dynamics_substep_integration_sign", "dynamics_substep.cu",
     "gv[v] = gv[v] + a.c.dt * qdd[v];", "gv[v] = gv[v] - a.c.dt * qdd[v];",
     "dynamics_substep"),
    ("contact_cache_drops_the_cross_product", "contact_cache.cu",
     "const float j = m * (sv[i] + c[i]);", "const float j = m * (sv[i]);",
     "contact_cache"),
    ("shared_contact_solve_friction_sign", "wtw_contact.cuh",
     "const float dlt = -c.relax * vtn / w_tt;",
     "const float dlt = c.relax * vtn / w_tt;", "dynamics_substep"),
    ("contact_substep_halved_relaxation", "contact_substep.cu",
     "a.c.relax = f[F_RELAX];", "a.c.relax = 0.5f * f[F_RELAX];",
     "contact_substep"),
    ("contact_cache_does_not_compile", "contact_cache.cu",
     "const size_t npad = (size_t)a.npad;", "const size_t npad = (size_t)a.npad",
     "build"),
    ("p_control_damping_sign", "megastep.cu",
     "t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q[j]) - LD(I_KD, j) * qd[j];",
     "t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q[j]) + LD(I_KD, j) * qd[j];",
     "control_step_p"),
    ("cache_rebuild_drops_payload_scale", "wtw_cache.cuh",
     "const float scale0 = mass[0] / MS_MASS[0];",
     "const float scale0 = 1.0f;", "control_step_exact"),
    # the same edit in the team kernel's entry-cache build (K4, K4b)
    ("team_cache_drops_payload_scale", "megastep_team.cu",
     "const float scale0 = (MS_MASS[0] + payload) / MS_MASS[0];",
     "const float scale0 = 1.0f;", "control_step"),
    # K5 reads a stale M^-1 after its first substep: the matrix of substep 0,
    # plausible values one to three substeps old, as a read of the rewritten
    # cache through a path that is not coherent with the kernel's own stores
    # (__ldg) may return them
    ("exact_minv_stale_after_first_substep", "megastep.cu",
     "      cache_columns_dev(q, quat, pos, payload, comdisp, sw, sv, ex_A, "
     "ex_B,\n                        ex_m, ex_minv, pcp);",
     "      float stale[NV * NV];\n"
     "      cache_columns_dev(q, quat, pos, payload, comdisp, sw, sv, ex_A, "
     "ex_B,\n                        ex_m, si == 0 ? ex_minv : stale, pcp);",
     "control_step_exact"),
    # the general-normal rows (K4b's and K3b's) take the normal part of the
    # impulse as if n were +z
    ("normal_row_drops_normal_projection", "wtw_device.cuh",
     "const float l_n0 = lam[0] * n[0] + lam[1] * n[1] + lam[2] * n[2];",
     "const float l_n0 = lam[2];", "control_step_normals"),
    # K3b's normal row takes the mass W22 instead of n^T W n
    ("normals_substep_wnn_is_w22", "wtw_contact.cuh",
     "inv_wnn[p] = c.relax / quad3(W9, n);",
     "inv_wnn[p] = c.relax / W9[8];", "dynamics_substep_normals"),
)


def run_mutant(name, source, old, new, expect):
    work = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), work)
    for d in ("walk_these_ways_tpu_torch", "resources"):
        shutil.copytree(os.path.join(ROOT, d), os.path.join(work, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(work, CSRC, source)
    with open(path) as fh:
        text = fh.read()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {old!r} stands {text.count(old)} times in "
                         f"{source}, expected once")
    with open(path, "w") as fh:
        fh.write(text.replace(old, new))
    env = dict(os.environ, WTW_TORCH_BUILD_DIR=os.path.join(work, "build"))
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=work, env=env,
                       capture_output=True, text=True)
    passed, failed_at = [], None
    for line in p.stdout.splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("phase") == "kernel_vs_plain":
            if rec["ok"]:
                passed.append(f"{rec['kernel']}:{rec['state']}")
            else:
                failed_at = dict(kernel=rec["kernel"], state=rec["state"],
                                 max_abs_err=rec["max_abs_err"])
                break
    err_tail = p.stderr.strip().splitlines()[-1:] or [""]
    where = failed_at["kernel"] if failed_at else (
        "build" if "nvcc failed" in p.stderr else None)
    ok = p.returncode != 0 and where == expect \
        and '"ok": true, "device"' not in p.stdout
    print(json.dumps(dict(
        mutant=name, source=os.path.join(CSRC, source), edit=[old, new],
        exit_code=p.returncode, expected_to_fail_at=expect, failed_at=where,
        first_failure=failed_at, passed_before=passed,
        last_error_line=err_tail[0][:300], ok=ok)), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return ok


def main(names=()):
    unknown = set(names) - {m[0] for m in MUTANTS}
    if unknown:
        raise SystemExit(f"unknown mutants: {sorted(unknown)}")
    results = [run_mutant(*m) for m in MUTANTS if not names or m[0] in names]
    print(json.dumps(dict(ok=all(results), mutants=len(results),
                          killed=sum(results))))
    sys.exit(0 if all(results) else 1)


if __name__ == "__main__":
    main(sys.argv[1:])
