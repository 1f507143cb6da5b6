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
    # the warp-per-env dynamics (K4 is the first checked that runs them;
    # K3, K3b, K5 and the other control-step variants run them too)
    ("team_dynamics_bias_sign", "wtw_team.cuh",
     "s.x[lane] = s.tau[lane] - acc;", "s.x[lane] = s.tau[lane] + acc;",
     "control_step"),
    # the warp-per-env kernels' sum of the points' J^T dlam rows into the
    # dof slots reads one slot past a point's leg columns (the next point's
    # row)
    ("team_dof_sum_reads_past_the_points_columns", "wtw_team.cuh",
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
     "s.gv[lane] = s.gv0[lane] + dt * s.qdd[lane];",
     "s.gv[lane] = s.gv0[lane] - dt * s.qdd[lane];", "dynamics_substep"),
    # K3's point lanes write J_p^T dlam_p with one column's sign flipped
    ("dynamics_substep_jt_row_sign", "dynamics_substep.cu",
     "row[k] = Jp[0][k] * dl[0] + Jp[1][k] * dl[1] + Jp[2][k] * dl[2];",
     "row[k] = Jp[0][k] * dl[0] - Jp[1][k] * dl[1] + Jp[2][k] * dl[2];",
     "dynamics_substep"),
    # the per-substep route's entry cache writes the linear twist basis
    # with the wrong sign
    ("entry_cache_twist_basis_sign", "entry_cache.cu",
     "[](const TeamEnv& e, int k) { return (&e.sv[0][0])[k]; });",
     "[](const TeamEnv& e, int k) { return -(&e.sv[0][0])[k]; });",
     "entry_cache"),
    ("contact_cache_drops_the_cross_product", "contact_cache.cu",
     "j[i] = m * (sv[i] + c[i]);", "j[i] = m * (sv[i]);",
     "contact_cache"),
    # K1's column lists drop the last column that `anc` sets (the last
    # leg's last dof): J there is written as a zero and W loses its terms
    ("contact_cache_column_list_drops_a_column", "contact_cache.cu",
     "    for (int v = 0; v < NV; ++v) {\n      const float m = __ldg(",
     "    for (int v = 0; v < NV - 1; ++v) {\n      const float m = __ldg(",
     "contact_cache"),
    # K2's friction row pushes along the slip (the relaxation's sign flipped
    # in the friction step only: 1 / w_nn is formed before the call)
    ("contact_solve_friction_sign", "contact_substep.cu",
     "flat_row_update(v, W00, W01, W11, target, inv_wnn, relax, mu,",
     "flat_row_update(v, W00, W01, W11, target, inv_wnn, -relax, mu,",
     "contact_substep"),
    ("contact_substep_halved_relaxation", "contact_substep.cu",
     "const float relax = a.f[F_RELAX],",
     "const float relax = 0.5f * a.f[F_RELAX],", "contact_substep"),
    # K2's dense impulse apply leaves the last point (the last leg's foot)
    # out of the dof sums
    ("contact_substep_apply_skips_a_point", "contact_substep.cu",
     "for (int p = 0; p < NP; ++p) acc += s.jt[p][lane];",
     "for (int p = 0; p < NP - 1; ++p) acc += s.jt[p][lane];",
     "contact_substep"),
    ("contact_cache_does_not_compile", "contact_cache.cu",
     "const size_t npad = (size_t)a.npad;", "const size_t npad = (size_t)a.npad",
     "build"),
    # P control's damping term with the wrong sign, in the line K4c,
    # K4b-P and K5-P share (K4c is checked first)
    ("team_p_control_damping_sign", "megastep_team.cu",
     "t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q) - LD(I_KD, j) * qd;",
     "t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q) + LD(I_KD, j) * qd;",
     "control_step_p"),
    # the warp-per-env cache build drops the payload's inertia scale (K4 is
    # the first checked that runs it; K4b, K4c, K4b-P, K5, K5-P and the
    # entry-cache launch too)
    ("team_cache_drops_payload_scale", "wtw_team.cuh",
     "const float scale0 = (MS_MASS[0] + payload) / MS_MASS[0];",
     "const float scale0 = 1.0f;", "control_step"),
    # exact mode only (K5 is checked before K5-P; reuse mode's variants
    # pass): the cache is rebuilt at the first substep only, so the later
    # substeps run on the M^-1, J and W of substep 0, values one to three
    # substeps old
    ("exact_rebuild_only_at_first_substep", "megastep_team.cu",
     "    if constexpr (EXACT) {\n      // the whole cache",
     "    if (EXACT && si == 0) {\n      // the whole cache",
     "control_step_exact"),
    # exact mode only: the cache is rebuilt every substep but about the
    # entry base position, while r is taken from the current one
    ("exact_rebuild_keeps_the_entry_anchor", "megastep_team.cu",
     "      if (lane < 3) s.ref[lane] = s.pos[lane];\n      __syncwarp();\n"
     "      build_cache();",
     "      __syncwarp();\n      build_cache();",
     "control_step_exact"),
    # the general-normal rows (K4b's and K3b's) take the normal part of the
    # impulse as if n were +z
    ("normal_row_drops_normal_projection", "wtw_device.cuh",
     "const float l_n0 = lam[0] * n[0] + lam[1] * n[1] + lam[2] * n[2];",
     "const float l_n0 = lam[2];", "control_step_normals"),
    # K3b's normal row takes the mass W22 instead of n^T W n
    ("normals_substep_wnn_is_w22", "dynamics_substep.cu",
     "inv_wnn = relax / quad3(W9, nrm);", "inv_wnn = relax / W9[8];",
     "dynamics_substep_normals"),
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
