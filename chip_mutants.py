#!/usr/bin/env python3
"""Mutation check of `chip_smoke.py` on one NVIDIA GPU.

    python3 chip_mutants.py [name ...]
    python3 chip_mutants.py --tests [name ...]

For each mutant below (or each one named): copies `chip_smoke.py`, the
port's package and `resources/` into `build/mutants/<name>/`, makes ONE edit
in one source of the package there (a kernel source, the dense route in
physics/engine.py, the train/eval split or the data-parallel draws in
envs/go1_env.py, the RMA update in learn/ppo_rma.py, the data-parallel
gradient sum in learn/ppo.py, the MuJoCo state mapping in models/mjcf.py or
the deploy loader in deploy/deploy_policy.py), runs
`python3 chip_smoke.py` in the copy and records its exit code and the first
check that failed.  The smoke test must exit non-zero on every mutant, and
at the check named here; kernels that the edit does not reach must still
pass before it.  Prints one JSON line per
mutant and a last line `{"ok": ..., "mutants": n}`; exits non-zero if a
mutant survived.

With `--tests` (on a CPU machine with the JAX package's dependencies) only
the mutants of Python sources run, each through the parity tests of its
source in the copy (`TESTS`, or the mutant's own in `TESTS_OF`; the tests
and the JAX package copied too), which must fail.

The working tree is never edited.
"""
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "walk_these_ways_tpu_torch"
# (name, source, text to replace, replacement, the check that must fail)
MUTANTS = (
    # the warp-per-env dynamics (K4 is the first checked that runs them;
    # K3, K3b, K5 and the other control-step variants run them too)
    ("team_dynamics_bias_sign", "csrc/wtw_team.cuh",
     "s.x[lane] = s.tau[lane] - acc;", "s.x[lane] = s.tau[lane] + acc;",
     "control_step"),
    # the warp-per-env kernels' sum of the points' J^T dlam rows into the
    # dof slots reads one slot past a point's leg columns (the next point's
    # row)
    ("team_dof_sum_reads_past_the_points_columns", "csrc/wtw_team.cuh",
     "if (k >= 0 && k < MS_PT_N[p]) acc += s.u.jt[p][6 + k];",
     "if (k >= 0 && k <= MS_PT_N[p]) acc += s.u.jt[p][6 + k];",
     "control_step"),
    # the in-kernel heightfield sample (K4b) tilts the normal the wrong way
    # along x
    ("heightfield_sample_slope_sign", "csrc/wtw_device.cuh",
     "const float nx = -dhdx, ny = -dhdy, nz = 1.0f;",
     "const float nx = dhdx, ny = -dhdy, nz = 1.0f;",
     "control_step_normals"),
    ("dynamics_substep_integration_sign", "csrc/dynamics_substep.cu",
     "s.gv[lane] = s.gv0[lane] + dt * s.qdd[lane];",
     "s.gv[lane] = s.gv0[lane] - dt * s.qdd[lane];", "dynamics_substep"),
    # K3's point lanes write J_p^T dlam_p with one column's sign flipped
    ("dynamics_substep_jt_row_sign", "csrc/dynamics_substep.cu",
     "row[k] = Jp[0][k] * dl[0] + Jp[1][k] * dl[1] + Jp[2][k] * dl[2];",
     "row[k] = Jp[0][k] * dl[0] - Jp[1][k] * dl[1] + Jp[2][k] * dl[2];",
     "dynamics_substep"),
    # the per-substep route's entry cache writes the linear twist basis
    # with the wrong sign
    ("entry_cache_twist_basis_sign", "csrc/entry_cache.cu",
     "[](const TeamEnv& e, int k) { return (&e.sv[0][0])[k]; });",
     "[](const TeamEnv& e, int k) { return -(&e.sv[0][0])[k]; });",
     "entry_cache"),
    ("contact_cache_drops_the_cross_product", "csrc/contact_cache.cu",
     "j[i] = m * (sv[i] + c[i]);", "j[i] = m * (sv[i]);",
     "contact_cache"),
    # K1's column lists drop the last column that `anc` sets (the last
    # leg's last dof): J there is written as a zero and W loses its terms
    ("contact_cache_column_list_drops_a_column", "csrc/contact_cache.cu",
     "    for (int v = 0; v < NV; ++v) {\n      const float m = __ldg(",
     "    for (int v = 0; v < NV - 1; ++v) {\n      const float m = __ldg(",
     "contact_cache"),
    # K2's friction row pushes along the slip (the relaxation's sign flipped
    # in the friction step only: 1 / w_nn is formed before the call)
    ("contact_solve_friction_sign", "csrc/contact_substep.cu",
     "flat_row_update(v, W00, W01, W11, target, inv_wnn, relax, mu,",
     "flat_row_update(v, W00, W01, W11, target, inv_wnn, -relax, mu,",
     "contact_substep"),
    ("contact_substep_halved_relaxation", "csrc/contact_substep.cu",
     "const float relax = a.f[F_RELAX],",
     "const float relax = 0.5f * a.f[F_RELAX],", "contact_substep"),
    # K2's dense impulse apply leaves the last point (the last leg's foot)
    # out of the dof sums
    ("contact_substep_apply_skips_a_point", "csrc/contact_substep.cu",
     "for (int p = 0; p < NP; ++p) acc += s.jt[p][lane];",
     "for (int p = 0; p < NP - 1; ++p) acc += s.jt[p][lane];",
     "contact_substep"),
    ("contact_cache_does_not_compile", "csrc/contact_cache.cu",
     "const size_t npad = (size_t)a.npad;", "const size_t npad = (size_t)a.npad",
     "build"),
    # P control's damping term with the wrong sign, in the line K4c,
    # K4b-P and K5-P share (K4c is checked first)
    ("team_p_control_damping_sign", "csrc/megastep_team.cu",
     "t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q) - LD(I_KD, j) * qd;",
     "t = LD(I_KP, j) * (LD(I_TGT, si * NJ + j) - q) + LD(I_KD, j) * qd;",
     "control_step_p"),
    # the warp-per-env cache build drops the payload's inertia scale (K4 is
    # the first checked that runs it; K4b, K4c, K4b-P, K5, K5-P and the
    # entry-cache launch too)
    ("team_cache_drops_payload_scale", "csrc/wtw_team.cuh",
     "const float scale0 = (MS_MASS[0] + payload) / MS_MASS[0];",
     "const float scale0 = 1.0f;", "control_step"),
    # exact mode only (K5 is checked before K5-P; reuse mode's variants
    # pass): the cache is rebuilt at the first substep only, so the later
    # substeps run on the M^-1, J and W of substep 0, values one to three
    # substeps old
    ("exact_rebuild_only_at_first_substep", "csrc/megastep_team.cu",
     "    if constexpr (EXACT) {\n      // the whole cache",
     "    if (EXACT && si == 0) {\n      // the whole cache",
     "control_step_exact"),
    # exact mode only: the cache is rebuilt every substep but about the
    # entry base position, while r is taken from the current one
    ("exact_rebuild_keeps_the_entry_anchor", "csrc/megastep_team.cu",
     "      if (lane < 3) s.ref[lane] = s.pos[lane];\n      __syncwarp();\n"
     "      build_cache();",
     "      __syncwarp();\n      build_cache();",
     "control_step_exact"),
    # the general-normal rows (K4b's and K3b's) take the normal part of the
    # impulse as if n were +z
    ("normal_row_drops_normal_projection", "csrc/wtw_device.cuh",
     "const float l_n0 = lam[0] * n[0] + lam[1] * n[1] + lam[2] * n[2];",
     "const float l_n0 = lam[2];", "control_step_normals"),
    # K3b's normal row takes the mass W22 instead of n^T W n
    ("normals_substep_wnn_is_w22", "csrc/dynamics_substep.cu",
     "inv_wnn = relax / quad3(W9, nrm);", "inv_wnn = relax / W9[8];",
     "dynamics_substep_normals"),
    # the dense route's friction row pushes along the slip (both modes; the
    # first dense agreement, reuse mode, fails)
    ("dense_friction_sign", "physics/engine.py",
     "dlt = -params.relaxation * vt_norm / w_tt",
     "dlt = params.relaxation * vt_norm / w_tt",
     "dense_reuse_agreement"),
    # `physics_substep` (the dense route's exact mode) drops the w x v term
    # of the base point's acceleration; reuse mode passes
    ("dense_exact_drops_base_w_x_v", "physics/engine.py",
     "qdd[:, 3:6] + base_wxv", "qdd[:, 3:6]", "dense_exact_agreement"),
    # the train/eval split hands the eval slice the train slice's
    # domain-randomisation ranges
    ("eval_slice_gets_the_train_dr_range", "envs/go1_env.py",
     "ev = self.eval_cfg.domain_rand if self.eval_cfg else tr", "ev = tr",
     "eval_split_dr"),
    # the RMA update takes the adaptation module's target from the encoder
    # as it stood BEFORE the minibatch's main Adam step
    ("rma_target_before_the_main_step", "learn/ppo_rma.py",
     "            lr, kl_mean = ppo.main_step(main_opt, lr, loss, mean, std,\n"
     "                                        old_mu_mb, old_sigma_mb, args,\n"
     "                                        rows, mb)\n"
     "            lrs.append(float(lr))\n\n"
     "            # distillation: adaptation(hist) -> encoder(priv), the encoder\n"
     "            # as the main step left it (ppo.py:157-163)\n"
     "            with torch.no_grad():\n"
     "                target = policy.encoder(priv_mb)\n",
     "            with torch.no_grad():\n"
     "                target = policy.encoder(priv_mb)\n"
     "            lr, kl_mean = ppo.main_step(main_opt, lr, loss, mean, std,\n"
     "                                        old_mu_mb, old_sigma_mb, args,\n"
     "                                        rows, mb)\n"
     "            lrs.append(float(lr))\n\n",
     "rma_adaptation_target"),
    # data parallel: each rank steps Adam on its own part of the gradient
    # (the sum over the ranks is made, and dropped), so the ranks' replicated
    # parameters part (multi_rank: checksums differ)
    ("gradient_not_all_reduced", "learn/ppo.py",
     "        for p, g in zip(params, grads):\n"
     "            p.grad = g\n",
     "", "multi_rank"),
    # data parallel: the gradient sum takes rank 0's part only, so every
    # rank steps on the gradient of half of each minibatch (the checksums
    # still agree; multi_rank: the parameters' distance from the 1-rank
    # update, which the record's failed line reports)
    ("rank_gradient_of_half_the_minibatch", "learn/ppo.py",
     "            [p.grad for p in params] + [kl_mean])\n",
     "            [p.grad * float(rows.mesh.rank == 0) for p in params]\n"
     "            + [kl_mean])\n", "multi_rank"),
    # data parallel: each rank draws its own rows' shape from the generator
    # every rank holds alike, so rank 1's envs take rank 0's draws and the
    # 2-rank run parts from the 1-rank run (multi_rank: the gathered reset
    # differs)
    ("rank_draws_local_rows", "envs/go1_env.py",
     "        u = torch.rand((self.num_envs_global,) + tuple(shape_extra),\n"
     "                       generator=gen, device=self.device)\n"
     "        return lo + self.rows.take(u) * (hi - lo)\n",
     "        u = torch.rand((self.num_envs,) + tuple(shape_extra),\n"
     "                       generator=gen, device=self.device)\n"
     "        return lo + u * (hi - lo)\n", "multi_rank"),
    # the state mapping to MuJoCo writes the engine's xyzw quaternion where
    # MuJoCo keeps wxyz
    ("mjcf_quat_order_kept_xyzw", "models/mjcf.py",
     "    mjd.qpos[3:7] = [w, x, y, z]\n",
     "    mjd.qpos[3:7] = [x, y, z, w]\n", "mujoco_state_mapping"),
    # the deploy loader ignores meta/variant: an rma export's actor is fed
    # the history (cse's input) instead of obs
    ("deploy_rma_export_read_as_cse", "deploy/deploy_policy.py",
     '    variant = str(z["meta/variant"]) if "meta/variant" in z else "cse"\n',
     '    variant = "cse"\n', "deploy_export"),
)
# the CPU parity tests that `--tests` runs on a mutant of each Python source
TESTS = {"physics/engine.py": "tests/test_torch_dense.py",
         "envs/go1_env.py": "tests/test_torch_eval.py",
         "learn/ppo_rma.py": "tests/test_torch_rma.py",
         "learn/ppo.py":
         "tests/test_torch_ppo.py tests/test_torch_parallel.py",
         "models/mjcf.py": "tests/test_torch_formats.py",
         "deploy/deploy_policy.py": "tests/test_torch_deploy.py"}
# a mutant whose source's tests above do not run what it breaks
TESTS_OF = {"rank_draws_local_rows": "tests/test_torch_parallel.py"}


def run_mutant(name, source, old, new, expect, tests=False):
    work = os.path.join(ROOT, "build", "mutants", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), work)
    dirs = [PACKAGE, "resources"]
    if tests:
        # the parity tests import the JAX package, which the copy then holds
        dirs += ["tests", PACKAGE[:-len("_torch")]]
    for d in dirs:
        shutil.copytree(os.path.join(ROOT, d), os.path.join(work, d),
                        ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(work, PACKAGE, source)
    with open(path) as fh:
        text = fh.read()
    if text.count(old) != 1:
        raise SystemExit(f"{name}: {old!r} stands {text.count(old)} times in "
                         f"{source}, expected once")
    with open(path, "w") as fh:
        fh.write(text.replace(old, new))
    if tests:
        return run_tests(name, TESTS_OF.get(name, TESTS[source]), source,
                         old, new, work)
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
        elif rec.get("ok") is False:
            # another check than a kernel's (the dense route's agreements)
            failed_at = dict(kernel=rec.get("phase"), state=None,
                             max_abs_err=rec.get("max_abs_err"),
                             failed_checks=rec.get("failed_checks"),
                             readings=rec.get("readings"))
            break
    err_tail = p.stderr.strip().splitlines()[-1:] or [""]
    where = failed_at["kernel"] if failed_at else (
        "build" if "nvcc failed" in p.stderr else None)
    ok = p.returncode != 0 and where == expect \
        and '"ok": true, "device"' not in p.stdout
    print(json.dumps(dict(
        mutant=name, source=os.path.join(PACKAGE, source), edit=[old, new],
        exit_code=p.returncode, expected_to_fail_at=expect, failed_at=where,
        first_failure=failed_at, passed_before=passed,
        last_error_line=err_tail[0][:300], ok=ok)), flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return ok


def run_tests(name, tests, source, old, new, work):
    """The CPU parity tests `tests` of a mutant copy: killed when a test
    fails (pytest exit code 1, not a collection or usage error)."""
    p = subprocess.run(
        [sys.executable, "-m", "pytest", *tests.split(), "-q",
         "-p", "no:cacheprovider"],
        cwd=work, env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True)
    failed = [ln.split()[1] for ln in p.stdout.splitlines()
              if ln.startswith("FAILED ")]
    ok = p.returncode == 1 and len(failed) > 0
    print(json.dumps(dict(
        mutant=name, source=os.path.join(PACKAGE, source), edit=[old, new],
        run=tests, exit_code=p.returncode,
        tests_failed=len(failed), first_failed=failed[:5],
        summary=(p.stdout.strip().splitlines() or [""])[-1][:300], ok=ok)),
        flush=True)
    shutil.rmtree(work, ignore_errors=True)
    return ok


def main(args=()):
    tests = "--tests" in args
    names = [a for a in args if a != "--tests"]
    unknown = set(names) - {m[0] for m in MUTANTS}
    if unknown:
        raise SystemExit(f"unknown mutants: {sorted(unknown)}")
    results = [run_mutant(*m, tests=tests) for m in MUTANTS
               if (not names or m[0] in names)
               and (not tests or m[1].endswith(".py"))]
    print(json.dumps(dict(ok=all(results), mutants=len(results),
                          killed=sum(results))))
    sys.exit(0 if all(results) else 1)


if __name__ == "__main__":
    main(sys.argv[1:])
