"""The control-step, dynamics-substep, entry-cache, contact-cache and
contact-substep kernels' sources, built for the host CPU, against their
plain versions.

`csrc/megastep_team.cu`, `csrc/dynamics_substep.cu`,
`csrc/entry_cache.cu`, `csrc/contact_cache.cu` and `csrc/contact_substep.cu`
are compiled with g++ against a stand-in for
`cuda_runtime.h` (`__device__` and `__global__` empty, `__ldg(p)` = `*p`,
`__shared__` = `static`; a kernel's `<<<blocks, threads>>>` launch runs
each block's threads as `std::thread`s that meet at one barrier per warp
for each `__syncwarp` and at one per block for each `__syncthreads`, the
blocks one after another), loaded with ctypes and called through the
port's own operand packing (`ops/megastep.kernel_operands`,
`ops/dynamics.kernel_operands`, `ops/entry_cache.kernel_operands`,
`ops/contact.cache_operands` and `substep_operands`) on CPU tensors.
K4, K4b, K4c and K4b-P (the team kernel in reuse mode: entry cache and
heightfield samples in the launch) against
`control_step_reference` fed the eager build of the same state; K5 and
K5-P (the team kernel in exact mode: the cache rebuilt before every
substep) against `control_step_reference`; K3 and K3b against
`dynamics_substep_reference`; the per-substep route's entry-cache launch,
flat and on a heightfield, against the eager build
(`engine.build_pallas_env_inputs`), every lane; K1 against `cache_core`
and K2 against `contact_core`, with the robot's ancestor mask and with one
that sets one more column per point (so J has nonzeros outside the robot's
point-dof sparsity, which neither kernel may assume); after a reset and
after some random control steps, with the tolerance `chip_smoke.py` holds
the card to:
|kernel - plain| <= 2e-4 + 2e-4 |plain|.  The rough cases stand on the 2 x 2
rough-slope tiles of tests/test_torch_terrain.py.

This checks the arithmetic of a kernel edit without a GPU.  It does not see
what only the card does: the read-only data path, local memory, the launch
limits, the card's sinf and cosf.  Like nvcc (ops/_build.py), g++ is told not
to fuse multiply-adds (-ffp-contract=off), so every product and sum rounds as
in the plain version; what remains is the order of summation and the float32
library functions.

    PYTHONPATH=. python tests/test_torch_host_kernel.py [--num-envs 512]

prints one JSON line per variant and state with the largest errors at that
width.
"""
import ctypes
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import pytest
import torch

from walk_these_ways_tpu_torch import go1_config as t_cfg
from walk_these_ways_tpu_torch.envs import go1_env as t_env
from walk_these_ways_tpu_torch.ops import _build
from walk_these_ways_tpu_torch.ops import contact as t_pc
from walk_these_ways_tpu_torch.ops import dynamics as t_pd
from walk_these_ways_tpu_torch.ops import entry_cache as t_ec
from walk_these_ways_tpu_torch.ops import megastep as t_pm
from walk_these_ways_tpu_torch.physics import engine

torch.set_num_threads(1)
N, STEPS = 16, 12
ATOL, RTOL = 2e-4, 2e-4
OUT_NAMES = ("q", "qd", "pos", "quat", "lin", "ang", "pcp", "pcp_prev",
             "lam", "tau", "el", "ell", "vl", "vll")
ENTRY_NAMES = ("Sw", "Sv", "A", "B", "m", "Minv", "r", "p_cp", "rh", "n")

CUDA_RUNTIME_STAND_IN = r"""
#pragma once
#include <algorithm>
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
using std::max;
using std::min;
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __constant__ static const
#define __shared__ static
#define __restrict__ __restrict
struct wtw_dim3 { unsigned x = 0; };
static thread_local wtw_dim3 blockIdx, threadIdx, blockDim;
struct float4 { float x, y, z, w; };
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
// __syncwarp: the 32 threads of a warp meet at a barrier
class wtw_barrier {
  std::mutex m_;
  std::condition_variable cv_;
  int n_, waiting_ = 0;
  unsigned long gen_ = 0;
 public:
  explicit wtw_barrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(m_);
    const unsigned long gen = gen_;
    if (++waiting_ == n_) {
      waiting_ = 0;
      ++gen_;
      cv_.notify_all();
    } else {
      cv_.wait(lock, [&] { return gen_ != gen; });
    }
  }
};
static thread_local wtw_barrier* wtw_warp = nullptr;
static thread_local wtw_barrier* wtw_block = nullptr;
inline void __syncwarp(unsigned = 0xffffffffu) { wtw_warp->wait(); }
inline void __syncthreads() { wtw_block->wait(); }
// a warp-per-env kernel: each block's threads as std::threads, one barrier
// per warp and one for the block; the blocks one after another, so a
// __shared__ (static) array is the running block's
template <class F>
void wtw_host_launch_threads(int blocks, int threads, F kernel) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<std::unique_ptr<wtw_barrier>> warps;
    for (int w = 0; w * 32 < threads; ++w)
      warps.emplace_back(new wtw_barrier(std::min(32, threads - 32 * w)));
    wtw_barrier block(threads);
    std::vector<std::thread> team;
    for (int t = 0; t < threads; ++t)
      team.emplace_back([&, b, t] {
        blockIdx.x = b;
        threadIdx.x = t;
        blockDim.x = threads;
        wtw_warp = warps[t / 32].get();
        wtw_block = &block;
        kernel();
      });
    for (auto& th : team) th.join();
  }
}
"""


def build_host_library(model, out_dir, name="megastep_team"):
    """csrc/<name>.cu (megastep_team, dynamics_substep, entry_cache,
    contact_cache or contact_substep) for the host, with the header the
    card's build gets; returns the bound ctypes library.  The threads of a
    block run as std::threads (the stand-in's wtw_host_launch_threads)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    with open(os.path.join(_build.CSRC_DIR, name + ".cu")) as fh:
        src = fh.read()
    src, n = re.subn(rf"({name}_kernel(?:<[\w, ]+>)?)<<<(\w+), (\w+), 0, "
                     r"\w+>>>\((\w+)\);",
                     r"wtw_host_launch_threads(\2, \3, [&] { \1(\4); });",
                     src)
    if name == "megastep_team":
        assert n == 6, ("expected the launches of K4, K4b, K4c, K4b-P, K5 "
                        "and K5-P")
        header, counts = t_pm.library_spec(model)[1:]
    elif name == "dynamics_substep":
        assert n == 2, "expected the launches of K3 and K3b"
        header, counts = t_pd.library_spec(model.anc_dof_body,
                                           model.joint_body,
                                           model.cp_body)[1:]
    elif name == "entry_cache":
        assert n == 2, "expected the flat and the heightfield launches"
        header, counts = t_ec.library_spec(model)[1:]
    else:
        assert n == 1, f"expected the launch of {name}"
        spec = (t_pc.cache_spec if name == "contact_cache"
                else t_pc.substep_spec)
        header, counts = spec(model.nv, model.cp_body.shape[0])[1:]
    for fname, text in (("cuda_runtime.h", CUDA_RUNTIME_STAND_IN),
                        (_build.HEADER_NAME, header),
                        (name + "_host.cpp", src)):
        with open(os.path.join(out_dir, fname), "w") as fh:
            fh.write(text)
    lib_path = os.path.join(out_dir, f"lib{name}_host.so")
    cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
           "-pthread",
           "-Wno-unknown-pragmas", "-I", out_dir, "-I", _build.CSRC_DIR,
           "-o", lib_path, os.path.join(out_dir, name + "_host.cpp")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    return _build.bind(ctypes.CDLL(lib_path), name, *counts)


def host_control_step(libs, args, kwargs):
    """The team kernel's outputs for one `control_step` call on CPU tensors
    (reuse mode: K4, K4b, K4c, K4b-P; exact mode: K5, K5-P)."""
    ptrs, outs, floats, ints, _ = t_pm.kernel_operands(*args, **kwargs)
    _build.launch(libs["megastep_team"], "megastep_team", ptrs, outs, floats,
                  ints, 0)
    return tuple(o for o in outs if o is not None)


def host_dynamics_substep(lib, args, kwargs):
    """The kernel's outputs for one `dynamics_substep` call on CPU
    tensors."""
    kw = {k: v for k, v in kwargs.items() if k != "joint_body"}
    ptrs, outs, floats, ints = t_pd.kernel_operands(*args, **kw)
    _build.launch(lib, "dynamics_substep", ptrs, outs, floats, ints, 0)
    return outs


def host_entry_cache(lib, model, state, dyn, terrain):
    """The kernel's outputs for one `entry_cache` call on CPU tensors, at
    the per-substep route's block: Sw, Sv, A, B, m, M^-1, r, p_cp and, on a
    heightfield, rh and n."""
    ptrs, outs, floats, ints, _ = t_ec.kernel_operands(
        model, state, dyn, terrain, engine.SUBSTEP_BLOCK)
    _build.launch(lib, "entry_cache", ptrs, outs, floats, ints, 0)
    return tuple(o for o in outs if o is not None)


def eager_entry_cache(model, state, dyn, terrain):
    """The same outputs from the entry cache's plain version, the eager
    build (`engine.build_pallas_env_inputs`); rh and n on a heightfield
    only."""
    em, rh_t, _, _, _, n_t = engine.build_pallas_env_inputs(
        model, state, dyn, terrain, engine.SUBSTEP_BLOCK)
    out = (em.Sw_t, em.Sv_t, em.A_t, em.B_t, em.m_t, em.Minv_t, em.r_t,
           em.p_cp_t)
    return out if n_t is None else out + (rh_t, n_t)


def rough(cfg):
    """The 2 x 2 rough-slope tiles (tests/test_torch_terrain.py)."""
    return dataclasses.replace(cfg, terrain=dataclasses.replace(
        cfg.terrain, mesh_type="heightfield", num_rows=2, num_cols=2,
        terrain_length=4.0, terrain_width=4.0,
        terrain_proportions=(0.0, 1.0, 0.0, 0.0, 0.0),
        teleport_robots=False, curriculum=False, center_robots=False))


def configs(n):
    def quiet(cfg, **sim):
        return dataclasses.replace(
            cfg, noise=dataclasses.replace(cfg.noise, add_noise=False),
            sim=dataclasses.replace(cfg.sim, **sim))

    mob = t_cfg.mob_train_cfg(n)
    small = t_cfg.small_train_cfg(n)
    return {"K4": quiet(mob), "K4c": quiet(small),
            "K5": quiet(mob, reuse_matrices=False),
            "K5_P": quiet(small, reuse_matrices=False),
            "K4b": quiet(rough(mob)), "K4b_P": quiet(rough(small))}


def kernel_call(env, state, eager_cache=False):
    """(args, kwargs) of the control-step call that `env.step` makes from
    `state`; with `eager_cache`, the entry cache (and on a heightfield the
    normals) built on the host, as the plain version of the team kernel's
    variants is fed here."""
    _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
    return engine.megakernel_args(
        env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
        state.motor_strengths, env.torque_limits, ctrl,
        env.cfg.control.decimation, lam_in, exact=not env.reuse_matrices,
        eager_cache=eager_cache)


def substep_call(env, state):
    """(args, kwargs) of the dynamics-substep call that the per-substep
    route makes at the first substep of a control step from `state`: the
    cache of the state (with the surface normals on a heightfield), its
    anchor-point velocity and the torque model's torques."""
    m, p = env.model, env.sim_params
    block = engine.SUBSTEP_BLOCK
    dyn = env.dynamics_params(state)[1]
    em, rh_t, mu_t, e_t, g_t, n_t = engine.build_pallas_env_inputs(
        m, state.phys, dyn, env.terrain, block)
    anc_p = torch.tensor(m.anc_dof_body[:, m.cp_body].T, dtype=torch.float32)
    J_t, W_t = t_pc.build_contact_cache(anc_p, em.Sw_t, em.Sv_t, em.Minv_t,
                                        em.r_t)
    tau = env._compute_torques(state)[0]
    zeros = torch.zeros((env.num_envs, 6))
    tau_t = t_pc.to_env_minor(torch.cat([zeros, tau], dim=-1), block)
    ph = state.phys
    gv_t = t_pc.to_env_minor(
        torch.cat([ph.base_ang_vel, ph.base_lin_vel, ph.qd], dim=-1), block)
    vlim = engine._velocity_bounds(m, p, torch.float32, "cpu")
    args = (em.Sw_t, em.Sv_t, em.A_t, em.B_t, em.m_t, em.Minv_t, g_t, tau_t,
            gv_t, J_t, W_t, em.p_cp_t, rh_t, mu_t, e_t, vlim, n_t)
    kwargs = dict(anc=m.anc_dof_body, joint_body=m.joint_body,
                  cp_body=m.cp_body, dt=p.dt, num_iters=p.num_contact_iters,
                  relaxation=p.relaxation, baumgarte=p.contact_baumgarte,
                  slop=p.contact_slop,
                  max_depen=p.max_depenetration_velocity,
                  bounce_thresh=p.bounce_threshold_velocity)
    return args, kwargs


def extra_columns(anc_p):
    """The (P, nv) ancestor mask `anc_p` with one more column set per point
    (point p's (p mod k)-th of its k unset columns), so that J has nonzeros
    outside the robot's point-dof sparsity."""
    out = anc_p.clone()
    for p in range(out.shape[0]):
        unset = (out[p] == 0).nonzero().flatten()
        out[p, unset[p % len(unset)]] = 1.0
    return out


def contact_calls(env, state, extra=False):
    """K1's and K2's argument lists, and K2's solver statics, at the first
    substep of the per-substep route from `state`: the cache of the state
    with the robot's ancestor mask (with `extra`, `extra_columns` of it);
    K2 is fed the plain J and W of that mask, the entry velocity and the
    entry contact points."""
    m, p = env.model, env.sim_params
    block = engine.SUBSTEP_BLOCK
    em, rh_t, mu_t, e_t, _, _ = engine.build_pallas_env_inputs(
        m, state.phys, env.dynamics_params(state)[1], env.terrain, block)
    anc_p = torch.tensor(m.anc_dof_body[:, m.cp_body].T, dtype=torch.float32)
    if extra:
        anc_p = extra_columns(anc_p)
    k1 = (anc_p, em.Sw_t, em.Sv_t, em.Minv_t, em.r_t)
    J_t, W_t = t_pc.cache_core(*k1, eps=1e-6)
    ph = state.phys
    gv_t = t_pc.to_env_minor(
        torch.cat([ph.base_ang_vel, ph.base_lin_vel, ph.qd], dim=-1), block)
    vlim = engine._velocity_bounds(m, p, torch.float32, "cpu")
    k2 = (J_t, W_t, em.Minv_t, em.p_cp_t, gv_t, rh_t, mu_t, e_t, vlim)
    solver = dict(num_iters=p.num_contact_iters, relaxation=p.relaxation,
                  dt=p.dt, baumgarte=p.contact_baumgarte, slop=p.contact_slop,
                  max_depen=p.max_depenetration_velocity,
                  bounce_thresh=p.bounce_threshold_velocity)
    return k1, k2, solver


def host_contact(libs, variant, args, solver):
    """K1's (variant "K1...") or K2's outputs from the host build, through
    the wrappers' own operand packing."""
    if variant.startswith("K1"):
        name = "contact_cache"
        ptrs, outs, floats, ints = t_pc.cache_operands(*args)
    else:
        name = "contact_substep"
        ptrs, outs, floats, ints = t_pc.substep_operands(*args, **solver)
    _build.launch(libs[name], name, ptrs, outs, floats, ints, 0)
    return outs


def plain_contact(variant, args, solver):
    """The plain version of K1 (`cache_core`) or K2 (`contact_core`) and the
    names of its outputs."""
    if variant.startswith("K1"):
        return t_pc.cache_core(*args, eps=1e-6), ("J", "W")
    return t_pc.contact_core(*args, **solver), ("gv", "pcp", "lam")


CONTACT_VARIANTS = ("K1", "K2", "K1_non_robot_mask", "K2_outside_sparsity")


def errors(out_k, out_r, n, names=OUT_NAMES):
    """Per output: largest |kernel - plain| over the first `n` envs (every
    env with n None), and the count of elements beyond the tolerance."""
    res = {}
    for nm, a, b in zip(names, out_k, out_r):
        a, b = a[..., :n], b[..., :n]
        d = (a - b).abs()
        res[nm] = (float(d.max()), int((d > ATOL + RTOL * b.abs()).sum()))
    return res


def cases(n, steps, seed=0):
    """(variant, state name, args, kwargs, (args, kwargs) of the plain
    version) for each variant in two states: after a reset, and after
    `steps` random control steps (feet loaded).  K4, K4b, K4c and K4b-P
    build their entry cache (and sample the heightfield) in the kernel;
    their plain version is fed the eager build of the same state.  The
    states of K4 and K4b also give the dynamics-substep kernel's cases, K3
    (flat) and K3b (rough), and the entry-cache launch's (the state, the
    randomised dynamics and the terrain); K4's give K1's and K2's (their
    argument lists and K2's solver statics), with the robot's ancestor mask
    and with `extra_columns` of it."""
    out = []
    for variant, cfg in configs(n).items():
        env = t_env.LeggedRobotEnv(cfg, device="cpu")
        gen = t_env.make_generator(seed, "cpu")
        state, _ = env.reset(gen)
        for st_name in ("after_reset", f"{steps}_random_steps_in"):
            if st_name != "after_reset":
                for _ in range(steps):
                    state, *_ = env.step(state, torch.randn(
                        (n, 12), generator=gen))
            call = kernel_call(env, state)
            out.append((variant, st_name, *call,
                        kernel_call(env, state, eager_cache=True)))
            if variant in ("K4", "K4b"):
                call = substep_call(env, state)
                out.append(({"K4": "K3", "K4b": "K3b"}[variant], st_name,
                            *call, call))
                entry = (env.model, state.phys, env.dynamics_params(state)[1],
                         env.terrain)
                out.append(({"K4": "entry_cache",
                             "K4b": "entry_cache_rough"}[variant], st_name,
                            entry, None, None))
            if variant == "K4":
                for k1_name, k2_name, extra in (
                        ("K1", "K2", False),
                        ("K1_non_robot_mask", "K2_outside_sparsity", True)):
                    k1, k2, solver = contact_calls(env, state, extra)
                    out.append((k1_name, st_name, k1, None, None))
                    out.append((k2_name, st_name, k2, solver, None))
    return out


LIBRARIES = ("megastep_team", "dynamics_substep", "entry_cache",
             "contact_cache", "contact_substep")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    model = t_env.LeggedRobotEnv(t_cfg.small_train_cfg(4), device="cpu").model
    d = str(tmp_path_factory.mktemp("host"))
    libs = {name: build_host_library(model, d, name) for name in LIBRARIES}
    return libs, cases(N, STEPS)


@pytest.mark.parametrize("variant", ["K4", "K4c", "K5", "K5_P", "K4b",
                                     "K4b_P"])
def test_host_build_of_the_kernel_matches_its_plain_version(host, variant):
    libs, all_cases = host
    for v, state_name, args, kwargs, plain in all_cases:
        if v != variant:
            continue
        p_args, p_kwargs = plain
        # on a heightfield: the normals, or the terrain the kernel samples
        entry = kwargs["entry_inputs"]
        assert (p_args[5] is not None) == variant.startswith("K4b")
        assert (entry is not None) == variant.startswith("K4")
        assert args[0] is None and args[5] is None      # no em, no n_t
        assert entry is None or (entry[2] is not None) == (
            variant.startswith("K4b"))
        out_k = host_control_step(libs, args, kwargs)
        out_r = t_pm.control_step_reference(*p_args, **p_kwargs)
        assert len(out_k) == len(out_r) == (10 if variant.endswith("P")
                                            or variant == "K4c" else 14)
        for nm, (max_abs, beyond) in errors(out_k, out_r, N).items():
            assert beyond == 0, (state_name, nm, max_abs)
        # every lane finite, the padded ones included
        assert all(bool(torch.isfinite(o).all()) for o in out_k)
        if state_name != "after_reset":
            assert float(out_r[8][..., :N].abs().max()) > 0  # contacts


@pytest.mark.parametrize("variant", ["K3", "K3b", "entry_cache",
                                     "entry_cache_rough"])
def test_host_build_of_the_dynamics_substep_kernel_matches_its_plain_version(
        host, variant):
    """K3 and K3b against `dynamics_substep_reference`; the per-substep
    route's entry-cache launch, which feeds them on the card, flat and on a
    heightfield, against the eager build on every lane (the padded ones
    hold its zeros and +z normals)."""
    libs, all_cases = host
    for v, state_name, args, kwargs, _ in all_cases:
        if v != variant:
            continue
        if variant.startswith("entry_cache"):
            # off the card the wrapper raises: the eager build serves the CPU
            with pytest.raises(ValueError, match="unsupported device"):
                t_ec.entry_cache(*args, engine.SUBSTEP_BLOCK)
            out_k = host_entry_cache(libs["entry_cache"], *args)
            out_r = eager_entry_cache(*args)
            assert len(out_k) == len(out_r) == (
                10 if variant.endswith("rough") else 8)
            for nm, (max_abs, beyond) in errors(out_k, out_r, None,
                                                ENTRY_NAMES).items():
                assert beyond == 0, (state_name, nm, max_abs)
            continue
        assert (args[16] is not None) == (variant == "K3b")      # n_t
        out_k = host_dynamics_substep(libs["dynamics_substep"], args, kwargs)
        out_r = t_pd.dynamics_substep_reference(*args, **kwargs)
        for nm, (max_abs, beyond) in errors(out_k, out_r, N,
                                            ("gv", "pcp", "lam")).items():
            assert beyond == 0, (state_name, nm, max_abs)
        assert all(bool(torch.isfinite(o).all()) for o in out_k)
        if state_name != "after_reset":
            assert float(out_r[2][..., :N].abs().max()) > 0  # contacts


@pytest.mark.parametrize("variant", CONTACT_VARIANTS)
def test_host_build_of_the_contact_kernels_matches_its_plain_version(
        host, variant):
    """K1 against `cache_core` and K2 against `contact_core`, every lane
    (the padded ones included).  The `_non_robot_mask` and
    `_outside_sparsity` cases take an ancestor mask with one more column per
    point than the robot's, and J and W made with it: there the plain
    version on the robot's mask (K1) or on J cut to the robot's point-dof
    sparsity (K2) lies beyond the tolerance, so a kernel that took the
    robot's topology in place of its operands would fail."""
    libs, all_cases = host
    seen = 0
    for v, state_name, args, solver, _ in all_cases:
        if v != variant:
            continue
        seen += 1
        out_k = host_contact(libs, variant, args, solver)
        out_r, names = plain_contact(variant, args, solver)
        for nm, (max_abs, beyond) in errors(out_k, out_r, None,
                                            names).items():
            assert beyond == 0, (state_name, nm, max_abs)
        assert all(bool(torch.isfinite(o).all()) for o in out_k)
        if variant.startswith("K2") and state_name != "after_reset":
            assert float(out_r[2][..., :N].abs().max()) > 0  # contacts
        if variant in ("K1", "K2"):
            continue
        # the robot's mask: K1's case in the same state
        robot = next(a[0] for v1, s1, a, *_ in all_cases
                     if v1 == "K1" and s1 == state_name)
        if variant.startswith("K1"):
            assert bool((args[0] != robot).any())
            cut = (robot,) + args[1:]
        else:
            cut = (args[0] * robot[:, None, :, None],) + args[1:]
        out_cut = plain_contact(variant, cut, solver)[0]
        assert sum(e[1] for e in errors(out_cut, out_r, None,
                                        names).values()) > 0
    assert seen == 2


def test_host_build_of_k5_rebuilds_the_cache_before_every_substep(host):
    """K5 (the team kernel in exact mode) at a mid-stance state, feet on
    the ground, against its plain version, every output within the
    tolerance.  The same control step with the cache built once, at
    substep 0 (anchored at the entry base position, every solve cold: the
    plain version in reuse mode with `warm_iters` 0), lies beyond the
    tolerance of the exact plain version there, so a kernel that rebuilt
    its cache only at substep 0 would fail this test."""
    libs, _ = host
    n = 8
    cfg = configs(n)["K5"]
    env = t_env.LeggedRobotEnv(cfg, device="cpu")
    gen = t_env.make_generator(3, "cpu")
    state, _ = env.reset(gen)
    for _ in range(10):
        state, *_ = env.step(state, 0.3 * torch.randn((n, 12), generator=gen))
    args, kwargs = kernel_call(env, state)
    assert kwargs["exact_inputs"] is not None and args[-1] is None
    out_k = host_control_step(libs, args, kwargs)
    out_r = t_pm.control_step_reference(*args, **kwargs)
    for nm, (max_abs, beyond) in errors(out_k, out_r, n).items():
        assert beyond == 0, (nm, max_abs)
    assert all(bool(torch.isfinite(o).all()) for o in out_k)
    # mid-stance: some feet carry impulse in this step
    assert int((out_r[8][..., :n].abs().amax(dim=1) > 0).sum()) >= 4
    once = t_pm.control_step_reference(*args, **dict(
        kwargs, exact_inputs=None, warm_iters=0,
        entry_inputs=kwargs["exact_inputs"] + (None,)))
    assert sum(e[1] for e in errors(once, out_r, n).values()) > 0


def envs_beyond(out_k, out_r, n):
    """The envs in which some output lies beyond the tolerance."""
    bad = torch.zeros(n, dtype=torch.bool)
    for a, b in zip(out_k, out_r):
        a, b = a[..., :n], b[..., :n]
        d = ((a - b).abs() > ATOL + RTOL * b.abs()).reshape(-1, n)
        bad |= d.any(dim=0)
    return bad.nonzero().flatten().tolist()


def main(argv):
    """One JSON line per variant and state.  Where envs lie beyond the
    tolerance, the kernel and the plain version are run once more with the
    entry joint velocities (K3, K3b: all entry velocities) scaled by
    1 + 1e-7, and the line gives those
    envs' largest error then: a fault stays, while a rounding-level choice
    at one of the solver's branches (a contact point's gap crossing zero,
    a friction cone's edge) comes out the same in both."""
    n = int(argv[argv.index("--num-envs") + 1]) if "--num-envs" in argv \
        else N
    with tempfile.TemporaryDirectory() as d:
        model = t_env.LeggedRobotEnv(t_cfg.small_train_cfg(4),
                                     device="cpu").model
        libs = {name: build_host_library(model, d, name)
                for name in LIBRARIES}
        for variant, state_name, args, kwargs, plain in cases(n, 24):
            if variant in CONTACT_VARIANTS:
                out_r, names = plain_contact(variant, args, kwargs)
                errs = errors(host_contact(libs, variant, args, kwargs),
                              out_r, None, names)
                print(json.dumps(dict(
                    variant=variant, state=state_name, n_envs=n,
                    max_abs_err=max(e[0] for e in errs.values()),
                    beyond_tol=sum(e[1] for e in errs.values()))),
                    flush=True)
                continue
            if variant.startswith("entry_cache"):
                errs = errors(host_entry_cache(libs["entry_cache"], *args),
                              eager_entry_cache(*args), None, ENTRY_NAMES)
                print(json.dumps(dict(
                    variant=variant, state=state_name, n_envs=n,
                    max_abs_err=max(e[0] for e in errs.values()),
                    beyond_tol=sum(e[1] for e in errs.values()))),
                    flush=True)
                continue
            p_args, p_kwargs = plain
            if variant.startswith("K3"):
                def run(a, pa):
                    return (host_dynamics_substep(
                        libs["dynamics_substep"], a, kwargs),
                        t_pd.dynamics_substep_reference(*pa, **p_kwargs))
                names, qd_index = ("gv", "pcp", "lam"), 8       # gv_t
            else:
                def run(a, pa):
                    return (host_control_step(libs, a, kwargs),
                            t_pm.control_step_reference(*pa, **p_kwargs))
                names, qd_index = OUT_NAMES, 7                  # qd_t
            out_k, out_r = run(args, p_args)
            errs = errors(out_k, out_r, n, names)
            bad = envs_beyond(out_k, out_r, n)
            row = dict(
                variant=variant, state=state_name, n_envs=n,
                max_abs_err=max(e[0] for e in errs.values()),
                beyond_tol=sum(e[1] for e in errs.values()), envs_beyond=bad,
                outputs={k: dict(max_abs=e[0], beyond_tol=e[1])
                         for k, e in errs.items()})
            if bad:
                moved, p_moved = list(args), list(p_args)
                moved[qd_index] = args[qd_index] * (1 + 1e-7)
                p_moved[qd_index] = moved[qd_index]
                out_k2, out_r2 = run(moved, p_moved)
                row["those_envs_max_abs_err_with_qd_scaled_by_1_plus_1e-7"] \
                    = max(float((a[..., bad] - b[..., bad]).abs().max())
                          for a, b in zip(out_k2, out_r2))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
