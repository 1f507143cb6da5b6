"""Build and bind the port's CUDA kernels.

Every kernel of the port is one source under `csrc/` with a plain C
interface.  At first CUDA use its wrapper asks this module for the library:
the source, the shared device headers (`csrc/*.cuh`) and a small generated
header with the robot's static tables are hashed; on a miss `nvcc` compiles
the source for sm_90a into `build/<name>_<hash>/` at the repo root (or
`$WTW_TORCH_BUILD_DIR`), and the shared library is loaded with `ctypes`.
Any failure raises: nothing here gives way to a plain PyTorch version.

`build_libraries` takes several kernels at once and runs one `nvcc` for
each, all started together.  A library is bound (`bind`) once, when it is
loaded.

All kernels share one calling convention (`bind` / `launch`):

    int  <name>_launch(const void* const* in, void* const* out,
                       const float* f, const int* ip, void* stream);
    const char* <name>_error_string(int code);
    int  <name>_counts(int* n_in, int* n_out, int* n_f);

`in` / `out` are host arrays of device pointers, `f` float scalars, `ip` int
scalars; the launch goes onto `stream`, does not synchronise, and returns
the launch's cudaError_t (0 = launched).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np
import torch

CSRC_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
HEADER_NAME = "wtw_topology.h"

_LIBS = {}      # (name, hash) -> ctypes library
_KEYS = {}      # (name, header text) -> hash (sources are read once a process)
_HEADERS = {}   # topology (as bytes) -> header text
# name -> dict(seconds, cached, command, library, log) of its last build
builds = {}


def build_dir() -> str:
    root = os.environ.get("WTW_TORCH_BUILD_DIR")
    if root:
        return root
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "build")


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels are built from "
                       "csrc/*.cu at first CUDA use")


# -- generated headers --------------------------------------------------------


def dims_header(nv: int, P: int) -> str:
    """Header for a kernel that needs only the sizes (dofs, contact points)."""
    return ("// generated by walk_these_ways_tpu_torch/ops/_build.py\n"
            "#pragma once\n"
            f"#define MS_NV {int(nv)}\n#define MS_P {int(P)}\n")


def topology(anc, cp_body):
    """(anc (nv, nb) bool, anc_p (P, nv) bool, point->dof groups) from the
    ancestor mask and the contact points' bodies."""
    from .contact import point_dof_groups
    anc = np.asarray(anc).astype(bool)                         # (nv, nb)
    anc_p = anc[:, np.asarray(cp_body)].T                      # (P, nv)
    return anc, anc_p, tuple(point_dof_groups(anc_p))


def topology_header(anc, joint_body, cp_body, hidden: int = 0,
                    features: int = 0) -> str:
    """C header with the robot's static tables: sizes, the dof->body
    ancestor mask, the joint->body map and, per contact point, the one
    contiguous range of leg dofs it depends on beside the six base dofs.
    `hidden` / `features` size the actuator network for the control-step
    kernel (0 for kernels that evaluate none)."""
    memo = (np.asarray(anc).astype(bool).tobytes(),
            np.asarray(joint_body).tobytes(), np.asarray(cp_body).tobytes(),
            int(hidden), int(features))
    if memo in _HEADERS:
        return _HEADERS[memo]
    anc, anc_p, groups = topology(anc, cp_body)
    nv, nb = anc.shape
    nj = nv - 6
    P = anc_p.shape[0]
    pt_lo = np.full(P, 6, np.int64)
    pt_n = np.zeros(P, np.int64)
    pos = 6
    for (s, p, lo, hi) in groups:
        if lo is None:
            continue
        if lo != pos:
            raise NotImplementedError("joint ranges must tile [6, nv)")
        pt_lo[s:p] = lo
        pt_n[s:p] = hi - lo
        pos = hi
    if pos != nv:
        raise NotImplementedError("joint ranges must tile [6, nv)")
    gmax = max(1, int(pt_n.max()))
    pt_anc = np.zeros((P, gmax), np.float32)
    for p in range(P):
        for k in range(int(pt_n[p])):
            pt_anc[p, k] = float(anc_p[p, pt_lo[p] + k])
    # every point depends on all six base dofs
    assert anc_p[:, :6].all()

    def arr(ctype, name, vals, fmt):
        body = ", ".join(fmt(v) for v in vals)
        return (f"__constant__ {ctype} {name}[{len(vals)}] = {{{body}}};")

    lines = [
        "// generated by walk_these_ways_tpu_torch/ops/_build.py",
        "#pragma once",
        f"#define MS_NB {nb}", f"#define MS_NJ {nj}", f"#define MS_NV {nv}",
        f"#define MS_P {P}", f"#define MS_GMAX {gmax}",
        f"#define MS_H {int(hidden)}", f"#define MS_F {int(features)}",
        arr("unsigned char", "MS_ANC", anc.astype(int).reshape(-1),
            lambda v: str(int(v))),
        arr("int", "MS_JOINT_BODY", np.asarray(joint_body),
            lambda v: str(int(v))),
        arr("int", "MS_PT_LO", pt_lo, lambda v: str(int(v))),
        arr("int", "MS_PT_N", pt_n, lambda v: str(int(v))),
        arr("float", "MS_PT_ANC", pt_anc.reshape(-1),
            lambda v: f"{float(v):.1f}f"),
    ]
    _HEADERS[memo] = "\n".join(lines) + "\n"
    return _HEADERS[memo]


def _f32(v) -> str:
    """A float32 C literal that reads back as np.float32(v)."""
    txt = f"{float(np.float32(v)):.9g}"
    return txt + ("f" if "." in txt or "e" in txt else ".0f")


def model_tables(model) -> str:
    """Header lines with the robot's constants for the in-kernel cache
    rebuild (csrc/wtw_cache.cuh, physics/envminor.cache_columns): the parent
    of each body, the joints in FK order and their depths, joint axes (with
    the static K and K^2 of each axis' rotation), anchors, body masses, COMs
    and inertias, the contact points' bodies and offsets, and the joint
    pairs whose mass-matrix entry is nonzero.  Defines MS_HAVE_MODEL."""
    nb, nj = model.nb, model.nj
    parent = np.asarray(model.parent)

    def depth(b):
        d = 0
        while parent[b] >= 0:
            b, d = int(parent[b]), d + 1
        return d

    depths = [depth(int(model.joint_body[j])) for j in range(nj)]
    order = np.argsort(depths, kind="stable")
    K = np.zeros((nj, 3, 3))
    for j, a in enumerate(np.asarray(model.joint_axis, np.float64)):
        K[j] = [[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]]
    KK = np.einsum("jik,jkl->jil", K, K)
    jb = np.asarray(model.joint_body)
    jj_sub = np.asarray(model.subtree)[jb[:, None], jb[None, :]]

    def arr(ctype, name, vals, fmt):
        vals = np.asarray(vals).reshape(-1)
        body = ", ".join(fmt(v) for v in vals)
        return f"__constant__ {ctype} {name}[{len(vals)}] = {{{body}}};"

    def ints(name, vals):
        return arr("int", name, vals, lambda v: str(int(v)))

    def floats(name, vals):
        return arr("float", name, vals, _f32)

    lines = [
        "#define MS_HAVE_MODEL 1",
        ints("MS_PARENT", parent), ints("MS_FK_ORDER", order),
        # a joint's depth in the tree: the team kernel's FK runs the joints
        # of one depth at a time
        ints("MS_JOINT_DEPTH", depths), f"#define MS_FK_DEPTHS {max(depths)}",
        floats("MS_JOINT_AXIS", model.joint_axis),
        floats("MS_JOINT_K", K), floats("MS_JOINT_KK", KK),
        floats("MS_JOINT_ANCHOR", model.joint_anchor),
        floats("MS_MASS", model.mass), floats("MS_COM", model.com),
        floats("MS_INERTIA", model.inertia),
        ints("MS_CP_BODY", model.cp_body),
        floats("MS_CP_OFFSET", model.cp_offset),
        arr("unsigned char", "MS_JJ_SUB", jj_sub.astype(int),
            lambda v: str(int(v))),
    ]
    assert nb == len(parent)
    return "\n".join(lines) + "\n"


# -- compile + load -----------------------------------------------------------


def _key(name: str, header: str) -> str:
    if (name, header) in _KEYS:
        return _KEYS[(name, header)]
    h = hashlib.sha1()
    for path in [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(header.encode())
    _KEYS[(name, header)] = h.hexdigest()[:16]
    return _KEYS[(name, header)]


def build_libraries(specs):
    """`specs`: [(name, header text, (n_in, n_out, n_f))] with
    `csrc/<name>.cu` the source and the lengths of its argument lists as the
    wrapper knows them.  Compiles every library that is not built yet — one
    nvcc each, all started together — loads and binds them and returns them
    in order.  Raises on any failure."""
    jobs = []
    for name, header, arg_counts in specs:
        key = _key(name, header)
        out_dir = os.path.join(build_dir(), f"{name}_{key}")
        lib_path = os.path.join(out_dir, f"lib{name}.so")
        job = dict(name=name, key=key, lib_path=lib_path, proc=None, cmd=None,
                   arg_counts=arg_counts, t0=time.time())
        if (name, key) not in _LIBS and not os.path.exists(lib_path):
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, HEADER_NAME), "w") as fh:
                fh.write(header)
            job["tmp"] = lib_path + f".tmp{os.getpid()}"
            # -Xptxas -v: registers and stack per function go into the log.
            # -fmad=false: no fused multiply-adds, so every product rounds
            # on its own as in the plain versions the kernels are held to
            # elementwise; exact mode's cold solves on a closed-form M^-1
            # rebuilt every substep amplify fused rounding beyond that
            # tolerance (PERF.md)
            job["cmd"] = [
                find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-fmad=false", "-shared",
                "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-I", out_dir, "-I", CSRC_DIR,
                "-o", job["tmp"], os.path.join(CSRC_DIR, name + ".cu")]
            job["proc"] = subprocess.Popen(
                job["cmd"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
        jobs.append(job)
    failed = []
    for job in jobs:
        log = ""
        if job["proc"] is not None:
            log, _ = job["proc"].communicate()
            if job["proc"].returncode != 0:
                failed.append(f"nvcc failed ({job['proc'].returncode}): "
                              f"{' '.join(job['cmd'])}\n{log}")
                continue
            os.replace(job["tmp"], job["lib_path"])
        if (job["name"], job["key"]) not in _LIBS:
            _LIBS[(job["name"], job["key"])] = bind(
                ctypes.CDLL(job["lib_path"]), job["name"], *job["arg_counts"])
            builds[job["name"]] = dict(
                seconds=time.time() - job["t0"], cached=job["proc"] is None,
                command=" ".join(job["cmd"]) if job["cmd"] else None,
                library=job["lib_path"], log=log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [_LIBS[(job["name"], job["key"])] for job in jobs]


def build_library(name: str, header: str, arg_counts):
    return build_libraries([(name, header, arg_counts)])[0]


def bind(lib, name: str, n_in: int, n_out: int, n_f: int):
    """Set the argument types of `<name>_launch` and check that the source
    and the wrapper agree on the lengths of the argument lists."""
    launch = getattr(lib, name + "_launch")
    launch.argtypes = [ctypes.c_void_p] * 5
    launch.restype = ctypes.c_int
    err = getattr(lib, name + "_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    counts_fn = getattr(lib, name + "_counts")
    counts_fn.argtypes = [ctypes.c_void_p] * 3
    counts_fn.restype = ctypes.c_int
    counts = [ctypes.c_int() for _ in range(3)]
    counts_fn(*[ctypes.byref(c) for c in counts])
    if [c.value for c in counts] != [n_in, n_out, n_f]:
        raise RuntimeError(f"csrc/{name}.cu and its wrapper disagree on the "
                           "kernel's argument lists")
    return lib


def launch(lib, name: str, in_ptrs, outs, floats, ints, stream: int):
    """Launch `<name>` on `stream` (a None output is a null slot); raises if
    the launch is refused."""
    in_arr = (ctypes.c_void_p * len(in_ptrs))(*in_ptrs)
    out_arr = (ctypes.c_void_p * len(outs))(
        *[None if o is None else o.data_ptr() for o in outs])
    f_arr = (ctypes.c_float * len(floats))(*floats)
    i_arr = (ctypes.c_int * len(ints))(*[int(i) for i in ints])
    rc = getattr(lib, name + "_launch")(in_arr, out_arr, f_arr, i_arr,
                                        ctypes.c_void_p(stream))
    if rc != 0:
        msg = getattr(lib, name + "_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {rc} ({msg})")


def check(name, x, shape, dev):
    """Device, dtype, shape and contiguity of a kernel operand."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != dev:
        raise ValueError(f"{name}: on {x.device}, expected {dev}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {x.dtype}, expected float32")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return x
