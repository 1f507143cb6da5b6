#!/usr/bin/env python3
"""Where the time of the port's kernels goes, on one NVIDIA GPU.

    python3 kernel_ablation.py [source ...]

Builds `csrc/megastep_team.cu` (the team control-step kernel),
`csrc/dynamics_substep.cu` (the dynamics-substep kernel),
`csrc/contact_cache.cu` (K1) and `csrc/contact_substep.cu` (K2), or the
sources named (`megastep_team`, `dynamics_substep`, `contact_cache`,
`contact_substep`), as they are and in copies with one part of their work
cut out or one launch setting changed (one text edit each, under `build/ablation/`, one nvcc each, all started
together), times every copy with CUDA events over 20 launches on its
source's inputs, each 24 random control steps in at 4000 envs: for the team
kernel the default route's arguments (K4, `mob_train_cfg`), the P-control
route's (K4c, `small_train_cfg`), the rough P-control route's (K4b-P,
`rough_train_cfg` with P control) and the exact routes' (K5, K5-P: the same
flat configurations with `sim.reuse_matrices=False`; for them also a copy
whose per-substep cache rebuild is cut to substep 0); for the
dynamics-substep kernel the
first substep's arguments on the per-substep route (K3, `mob_train_cfg`;
K3b, `rough_train_cfg`; `sim.megastep=False`); for K1 and K2 the same
substep of `mob_train_cfg`'s per-substep route (K1 on the entry cache the
card builds, K2 on K1's J and W and the entry velocity).  Prints one JSON
line per
input and variant with its time beside the unchanged kernel's and ptxas's
registers and spills, then the card's name and power limit.  The cut
copies compute wrong results: they are timed, never checked
(`chip_smoke.py` checks the kernels).  Runs nothing else; needs one CUDA
device.
"""
import ctypes
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import torch

if not torch.cuda.is_available():
    sys.stderr.write("kernel_ablation.py needs a CUDA device\n")
    sys.exit(2)

from walk_these_ways_tpu_torch.envs.go1_env import (  # noqa: E402
    LeggedRobotEnv, make_generator)
from walk_these_ways_tpu_torch.go1_config import (  # noqa: E402
    mob_train_cfg, rough_train_cfg, small_train_cfg)
from walk_these_ways_tpu_torch.ops import (  # noqa: E402
    _build, contact, dynamics, entry_cache, megastep)
from walk_these_ways_tpu_torch.physics import engine  # noqa: E402

UNBOUNDED = ("registers_unbounded", "__launch_bounds__ asks for no number "
             "of resident blocks (ptxas may use more registers a thread)",
             [("__launch_bounds__(TEAM * TEAM_ENVS, TEAM_MIN_BLOCKS)",
               "__launch_bounds__(TEAM * TEAM_ENVS)")])
# per source: (name, what it changes, [(text, replacement)] in the source)
VARIANTS = {
    "megastep_team": (
        ("kernel", "the kernel as it is", []),
        ("no_actuator_net", "the two hidden layers skipped (torques from "
         "zeros)", [("for (int jj = 0; jj < NJ; jj += 2) {",
                     "for (int jj = 0; jj < 0; jj += 2) {")]),
        ("no_entry_cache", "the cache build skipped (exact mode: at every "
         "substep)", [("    team_entry_cache(s, q, LD(I_PAYLOAD, 0), "
                       "comdisp, mk, lane);\n", "")]),
        ("rebuild_at_first_substep_only", "exact mode's cache rebuilt at "
         "substep 0 only (the later substeps on its M^-1, J and W)",
         [("    if constexpr (EXACT) {\n      // the whole cache",
           "    if (EXACT && si == 0) {\n      // the whole cache")]),
        ("no_contact_sweeps", "no projected-Jacobi sweep (gaps, seed and "
         "point advance kept)", [("for (int it = 0; it < iters; ++it) {",
                                  "for (int it = 0; it < 0; ++it) {")]),
        ("one_dynamics_evaluation", "the midpoint rule's second dynamics "
         "evaluation skipped", [("    team_dynamics(s, s.gv, mk, lane);\n",
                                 "")]),
        UNBOUNDED),
    "dynamics_substep": (
        ("kernel", "the kernel as it is", []),
        ("no_contact_sweeps", "no projected-Jacobi sweep (staging, "
         "dynamics, gaps and point advance kept)",
         [("for (int it = 0; it < a.num_iters; ++it) {",
           "for (int it = 0; it < 0; ++it) {")]),
        ("one_dynamics_evaluation", "the midpoint rule's second dynamics "
         "evaluation skipped", [("  team_dynamics(s, s.gv, mk, lane);\n",
                                 "")]),
        UNBOUNDED),
    "contact_cache": (
        ("kernel", "the kernel as it is", []),
        ("no_minv_products", "t_i = J_i M^-1 skipped (W from zeros; J, "
         "staging and stores kept)",
         [("    for (int ka = 0; ka < NV; ++ka) {",
           "    for (int ka = 0; ka < 0; ++ka) {")]),
        ("unguarded_inner_loop", "the t_i loop over all NV columns, M^-1 "
         "read at column 0 and zero past the list (the same result)",
         [("          if (kb < n) {\n            const float mm = "
           "row[column(cols, kb) * CC_ENVS];",
           "          {\n            const float mm = kb < n ? "
           "row[column(cols, kb) * CC_ENVS] : 0.0f;")]),
        ("registers_unbounded", "__launch_bounds__ asks for no number of "
         "resident blocks", [("__launch_bounds__(CC_THREADS, CC_MIN_BLOCKS)",
                              "__launch_bounds__(CC_THREADS)")])),
    "contact_substep": (
        ("kernel", "the kernel as it is", []),
        ("no_contact_sweeps", "no projected-Jacobi sweep (staging, J loads, "
         "gaps and point advance kept)",
         [("for (int it = 0; it < a.num_iters; ++it) {",
           "for (int it = 0; it < 0; ++it) {")]),
        ("min_blocks_4", "__launch_bounds__ asks for 4 resident blocks "
         "(64 registers a thread)",
         [("#define CS_MIN_BLOCKS 2 ", "#define CS_MIN_BLOCKS 4 ")]),
        ("min_blocks_3", "__launch_bounds__ asks for 3 resident blocks "
         "(80 registers a thread)",
         [("#define CS_MIN_BLOCKS 2 ", "#define CS_MIN_BLOCKS 3 ")]),
        ("registers_unbounded", "__launch_bounds__ asks for no number of "
         "resident blocks",
         [("__launch_bounds__(CS_TEAM * CS_ENVS, CS_MIN_BLOCKS)",
           "__launch_bounds__(CS_TEAM * CS_ENVS)")])),
}


# variants timed on some inputs only (the others run them as the kernel)
ONLY = {"rebuild_at_first_substep_only": ("K5", "K5-P")}


def headers(model):
    P = model.cp_body.shape[0]
    return {"megastep_team": megastep.library_spec(model),
            "dynamics_substep": dynamics.library_spec(
                model.anc_dof_body, model.joint_body, model.cp_body),
            "contact_cache": contact.cache_spec(model.nv, P),
            "contact_substep": contact.substep_spec(model.nv, P)}


def build(model, root, sources):
    """One nvcc per source and variant, all started together; returns the
    bound libraries and ptxas's register lines by (source, variant)."""
    specs = headers(model)
    procs = {}
    for src in sources:
        variants = VARIANTS[src]
        for name, _, edits in variants:
            d = os.path.join(root, src, name)
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(_build.CSRC_DIR, d)
            path = os.path.join(d, src + ".cu")
            text = open(path).read()
            for old, new in edits:
                if text.count(old) != 1:
                    raise SystemExit(f"{src} {name}: {old!r} stands "
                                     f"{text.count(old)} times")
                text = text.replace(old, new)
            open(path, "w").write(text)
            open(os.path.join(d, _build.HEADER_NAME), "w").write(
                specs[src][1])
            lib = os.path.join(d, f"lib{src}.so")
            cmd = [_build.find_nvcc(), "-gencode",
                   "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                   "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-I", d, "-o", lib, path]
            procs[(src, name)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs, logs = {}, {}
    for (src, name), (p, lib) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {src} {name}:\n{log}")
        logs[(src, name)] = [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "stack frame" in ln]
        libs[(src, name)] = _build.bind(ctypes.CDLL(lib), src,
                                        *specs[src][2])
    return libs, logs


def stepped(cfg, dev, n):
    """The env of `cfg` and its state 24 random control steps after a
    reset."""
    env = LeggedRobotEnv(cfg, device=dev)
    gen = make_generator(0, dev)
    state, _ = env.reset(gen)
    for _ in range(24):
        state, *_ = env.step(state, torch.randn((n, 12), generator=gen,
                                                device=dev))
    return env, state


def team_operands(dev, n):
    """Per input: the packed launch operands of the control step that
    `env.step` makes from the stepped state, and the tensors they point
    into (kept alive with them)."""
    rough_p = rough_train_cfg(n)
    rough_p = dataclasses.replace(rough_p, control=dataclasses.replace(
        rough_p.control, control_type="P"))
    def exact(cfg):
        return dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, reuse_matrices=False))

    out, model = {}, None
    for name, cfg in (("K4", mob_train_cfg(n)), ("K4c", small_train_cfg(n)),
                      ("K4b-P", rough_p), ("K5", exact(mob_train_cfg(n))),
                      ("K5-P", exact(small_train_cfg(n)))):
        env, state = stepped(cfg, dev, n)
        model = env.model
        _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
        args, kwargs = engine.megakernel_args(
            env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
            state.motor_strengths, env.torque_limits, ctrl,
            env.cfg.control.decimation, lam_in,
            exact=not env.reuse_matrices)
        out[name] = (megastep.kernel_operands(*args, **kwargs)[:4],
                     (args, kwargs))
    return model, out


def substep_operands(dev, n):
    """Per input: the packed launch operands of the dynamics-substep kernel
    at the first substep of the per-substep route's control step from the
    stepped state (the cache as `engine.build_dynamics_cache` builds it on
    the card, the torque model's torques, the entry velocity), and the
    tensors they point into."""
    out = {}
    for name, cfg in (("K3", mob_train_cfg(n)), ("K3b", rough_train_cfg(n))):
        cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
            cfg.sim, megastep=False))
        env, state = stepped(cfg, dev, n)
        m, p, ph = env.model, env.sim_params, state.phys
        po = engine.build_dynamics_cache(
            m, p, ph, env.dynamics_params(state)[1], env.terrain).pallas_ops
        tau = env._compute_torques(state)[0]
        tau_t = contact.to_env_minor(torch.cat(
            [torch.zeros((n, 6), device=dev), tau], dim=-1), po.block)
        gv_t = contact.to_env_minor(torch.cat(
            [ph.base_ang_vel, ph.base_lin_vel, ph.qd], dim=-1), po.block)
        vlim = engine._velocity_bounds(m, p, torch.float32, dev)
        out[name] = dynamics.kernel_operands(
            po.Sw_t, po.Sv_t, po.A_t, po.B_t, po.m_t, po.Minv_t, po.g_t,
            tau_t, gv_t, po.J_t, po.W_t, po.p_cp_t, po.rh_t, po.mu_t,
            po.e_t, vlim, po.n_t, anc=m.anc_dof_body, cp_body=m.cp_body,
            dt=p.dt, num_iters=p.num_contact_iters,
            relaxation=p.relaxation, baumgarte=p.contact_baumgarte,
            slop=p.contact_slop, max_depen=p.max_depenetration_velocity,
            bounce_thresh=p.bounce_threshold_velocity), (po, tau_t, gv_t,
                                                         vlim)
    return out


def contact_operands(dev, n):
    """K1's and K2's packed launch operands at the first substep of the
    flat per-substep route's control step from the stepped state (the entry
    cache as the card builds it; K2 on K1's J and W and the entry
    velocity), and the tensors they point into."""
    cfg = mob_train_cfg(n)
    cfg = dataclasses.replace(cfg, sim=dataclasses.replace(
        cfg.sim, megastep=False))
    env, state = stepped(cfg, dev, n)
    m, p, ph = env.model, env.sim_params, state.phys
    dyn = env.dynamics_params(state)[1]
    em = entry_cache.entry_cache(m, ph, dyn, env.terrain,
                                 engine.SUBSTEP_BLOCK)[0]
    po = engine.build_dynamics_cache(m, p, ph, dyn, env.terrain).pallas_ops
    anc_p = torch.tensor(m.anc_dof_body[:, m.cp_body].T,
                         dtype=torch.float32, device=dev).contiguous()
    k1 = (anc_p, em.Sw_t, em.Sv_t, em.Minv_t, em.r_t)
    gv_t = contact.to_env_minor(torch.cat(
        [ph.base_ang_vel, ph.base_lin_vel, ph.qd], dim=-1), po.block)
    vlim = engine._velocity_bounds(m, p, torch.float32, dev)
    k2 = (po.J_t, po.W_t, po.Minv_t, po.p_cp_t, gv_t, po.rh_t, po.mu_t,
          po.e_t, vlim)
    solver = dict(num_iters=p.num_contact_iters, relaxation=p.relaxation,
                  dt=p.dt, baumgarte=p.contact_baumgarte,
                  slop=p.contact_slop,
                  max_depen=p.max_depenetration_velocity,
                  bounce_thresh=p.bounce_threshold_velocity)
    return {("contact_cache", "K1"): (contact.cache_operands(*k1), k1),
            ("contact_substep", "K2"): (
                contact.substep_operands(*k2, **solver), k2)}


def main(sources=tuple(VARIANTS)):
    unknown = set(sources) - set(VARIANTS)
    if unknown:
        raise SystemExit(f"unknown sources {sorted(unknown)}: one of "
                         f"{tuple(VARIANTS)}")
    dev = torch.device("cuda", 0)
    n = 4000
    inputs = {}
    if "megastep_team" in sources:
        inputs.update({("megastep_team", k): v
                       for k, v in team_operands(dev, n)[1].items()})
    if "dynamics_substep" in sources:
        inputs.update({("dynamics_substep", k): v
                       for k, v in substep_operands(dev, n).items()})
    if {"contact_cache", "contact_substep"} & set(sources):
        inputs.update({k: v for k, v in contact_operands(dev, n).items()
                       if k[0] in sources})
    model = LeggedRobotEnv(mob_train_cfg(4), device=dev).model
    libs, logs = build(model, os.path.join(_build.build_dir(), "ablation"),
                       sources)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def time_ms(src, lib, ops):
        def once():
            _build.launch(lib, src, *ops, stream)
        for _ in range(3):
            once()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            once()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 20

    for (src, inp), (ops, _) in inputs.items():
        # in turns: kernel, each variant, kernel
        variants = VARIANTS[src]
        base = [time_ms(src, libs[(src, "kernel")], ops)]
        rows = []
        for name, what, _ in variants[1:]:
            if inp in ONLY.get(name, (inp,)):
                rows.append((name, what,
                             time_ms(src, libs[(src, name)], ops)))
        base.append(time_ms(src, libs[(src, "kernel")], ops))
        print(json.dumps(dict(source=src, input=inp, variant="kernel",
                              what=variants[0][1], ms=base, n_envs=n,
                              ptxas=logs[(src, "kernel")])), flush=True)
        for name, what, ms in rows:
            print(json.dumps(dict(source=src, input=inp, variant=name,
                                  what=what, ms=ms, kernel_ms=sum(base) / 2,
                                  n_envs=n, ptxas=logs[(src, name)])),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or tuple(VARIANTS))
