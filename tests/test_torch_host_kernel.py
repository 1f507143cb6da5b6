"""The control-step kernel's source, built for the host CPU, against its plain
version.

`csrc/megastep.cu` is compiled with g++ against a stand-in for
`cuda_runtime.h` (`__device__` and `__global__` empty, `__ldg(p)` = `*p`,
each `<<<blocks, threads>>>` launch a loop over the grid), loaded with ctypes and called through the port's own operand
packing (`ops/megastep.kernel_operands`) on CPU tensors.  K4, K4c and K5 with
either torque model are held against `control_step_reference` after a reset
and after some random control steps, with the tolerance `chip_smoke.py`
holds the card to: |kernel - plain| <= 2e-4 + 2e-4 |plain|.

This checks the arithmetic of a kernel edit without a GPU.  It does not see
what only the card does: the read-only data path, local memory, the launch
limits, the card's sinf and cosf.  Like nvcc (ops/_build.py), g++ is told not
to fuse multiply-adds (-ffp-contract=off), so every product and sum rounds as
in the plain version; what remains is the order of summation and the float32
library functions.

    PYTHONPATH=. python tests/test_torch_host_kernel.py [--num-envs 4000]

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
from walk_these_ways_tpu_torch.ops import megastep as t_pm
from walk_these_ways_tpu_torch.physics import engine

torch.set_num_threads(1)
N, STEPS = 16, 12
ATOL, RTOL = 2e-4, 2e-4
OUT_NAMES = ("q", "qd", "pos", "quat", "lin", "ang", "pcp", "pcp_prev",
             "lam", "tau", "el", "ell", "vl", "vll")

CUDA_RUNTIME_STAND_IN = r"""
#pragma once
#include <cmath>
#include <cstddef>
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(n)
#define __constant__ static const
#define __restrict__ __restrict
struct wtw_dim3 { unsigned x = 0; };
static thread_local wtw_dim3 blockIdx, threadIdx, blockDim;
template <class T> inline T __ldg(const T* p) { return *p; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}
template <class F> void wtw_host_launch(int blocks, int threads, F kernel) {
  blockDim.x = threads;
  for (int b = 0; b < blocks; ++b)
    for (int t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      kernel();
    }
}
"""


def build_host_library(model, out_dir):
    """csrc/megastep.cu for the host, with the header the card's build gets;
    returns the bound ctypes library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host C++ compiler (g++)")
    with open(os.path.join(_build.CSRC_DIR, "megastep.cu")) as fh:
        src = fh.read()
    src, n = re.subn(r"(megastep_kernel<\w+, \w+>)<<<(\w+), (\w+), 0, \w+>>>"
                     r"\((\w+)\);",
                     r"wtw_host_launch(\2, \3, [&] { \1(\4); });", src)
    assert n == 4, "expected the four launches of the kernel's variants"
    for name, text in (("cuda_runtime.h", CUDA_RUNTIME_STAND_IN),
                       (_build.HEADER_NAME,
                        t_pm.topology_header(model, 32, 6)),
                       ("megastep_host.cpp", src)):
        with open(os.path.join(out_dir, name), "w") as fh:
            fh.write(text)
    lib_path = os.path.join(out_dir, "libmegastep_host.so")
    cmd = [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
           "-Wno-unknown-pragmas", "-I", out_dir, "-I", _build.CSRC_DIR,
           "-o", lib_path, os.path.join(out_dir, "megastep_host.cpp")]
    p = subprocess.run(cmd, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    return _build.bind(ctypes.CDLL(lib_path), "megastep", 38, 14, 12)


def host_control_step(lib, args, kwargs):
    """The kernel's outputs for one `control_step` call on CPU tensors."""
    ptrs, outs, floats, ints, _ = t_pm.kernel_operands(
        *args[:5], *args[6:], **kwargs)
    _build.launch(lib, "megastep", ptrs, outs, floats, ints, 0)
    return tuple(o for o in outs if o is not None)


def configs(n):
    def quiet(cfg, **sim):
        return dataclasses.replace(
            cfg, noise=dataclasses.replace(cfg.noise, add_noise=False),
            sim=dataclasses.replace(cfg.sim, **sim))

    mob = t_cfg.mob_train_cfg(n)
    small = t_cfg.small_train_cfg(n)
    return {"K4": quiet(mob), "K4c": quiet(small),
            "K5": quiet(mob, reuse_matrices=False),
            "K5_P": quiet(small, reuse_matrices=False)}


def kernel_call(env, state):
    _, dyn, _, _, tgt_eff, ctrl, lam_in = env.control_step_inputs(state)
    return engine.megakernel_args(
        env.model, env.sim_params, state.phys, dyn, env.terrain, tgt_eff,
        state.motor_strengths, env.torque_limits, ctrl,
        env.cfg.control.decimation, lam_in, exact=not env.reuse_matrices)


def errors(out_k, out_r, n):
    """Per output: largest |kernel - plain| over the valid envs, and the
    count of elements beyond the tolerance."""
    res = {}
    for nm, a, b in zip(OUT_NAMES, out_k, out_r):
        a, b = a[..., :n], b[..., :n]
        d = (a - b).abs()
        res[nm] = (float(d.max()), int((d > ATOL + RTOL * b.abs()).sum()))
    return res


def cases(n, steps, seed=0):
    """(variant, state name, args, kwargs) for each variant in two states:
    after a reset, and after `steps` random control steps (feet loaded)."""
    out = []
    for variant, cfg in configs(n).items():
        env = t_env.LeggedRobotEnv(cfg, device="cpu")
        gen = t_env.make_generator(seed, "cpu")
        state, _ = env.reset(gen)
        out.append((variant, "after_reset", *kernel_call(env, state)))
        for _ in range(steps):
            state, *_ = env.step(state, torch.randn((n, 12), generator=gen))
        out.append((variant, f"{steps}_random_steps_in",
                    *kernel_call(env, state)))
    return out


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    model = t_env.LeggedRobotEnv(t_cfg.small_train_cfg(4), device="cpu").model
    lib = build_host_library(model, str(tmp_path_factory.mktemp("host")))
    return lib, cases(N, STEPS)


@pytest.mark.parametrize("variant", ["K4", "K4c", "K5", "K5_P"])
def test_host_build_of_the_kernel_matches_its_plain_version(host, variant):
    lib, all_cases = host
    for v, state_name, args, kwargs in all_cases:
        if v != variant:
            continue
        out_k = host_control_step(lib, args, kwargs)
        out_r = t_pm.control_step_reference(*args, **kwargs)
        assert len(out_k) == len(out_r) == (10 if variant in ("K4c", "K5_P")
                                            else 14)
        for nm, (max_abs, beyond) in errors(out_k, out_r, N).items():
            assert beyond == 0, (state_name, nm, max_abs)
        if state_name != "after_reset":
            assert float(out_r[8][..., :N].abs().max()) > 0  # contacts


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
    entry joint velocities scaled by 1 + 1e-7, and the line gives those
    envs' largest error then: a fault stays, while a rounding-level choice
    at one of the solver's branches (a contact point's gap crossing zero,
    a friction cone's edge) comes out the same in both."""
    n = int(argv[argv.index("--num-envs") + 1]) if "--num-envs" in argv \
        else N
    with tempfile.TemporaryDirectory() as d:
        model = t_env.LeggedRobotEnv(t_cfg.small_train_cfg(4),
                                     device="cpu").model
        lib = build_host_library(model, d)
        for variant, state_name, args, kwargs in cases(n, 24):
            out_k = host_control_step(lib, args, kwargs)
            out_r = t_pm.control_step_reference(*args, **kwargs)
            errs = errors(out_k, out_r, n)
            bad = envs_beyond(out_k, out_r, n)
            row = dict(
                variant=variant, state=state_name, n_envs=n,
                max_abs_err=max(e[0] for e in errs.values()),
                beyond_tol=sum(e[1] for e in errs.values()), envs_beyond=bad,
                outputs={k: dict(max_abs=e[0], beyond_tol=e[1])
                         for k, e in errs.items()})
            if bad:
                moved = list(args)
                moved[7] = args[7] * (1 + 1e-7)        # qd_t
                out_k2 = host_control_step(lib, moved, kwargs)
                out_r2 = t_pm.control_step_reference(*moved, **kwargs)
                row["those_envs_max_abs_err_with_qd_scaled_by_1_plus_1e-7"] \
                    = max(float((a[..., bad] - b[..., bad]).abs().max())
                          for a, b in zip(out_k2, out_r2))
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
