"""The per-substep route's entry cache on the card: the wrapper of
csrc/entry_cache.cu.

The per-substep route (`sim.megastep=False`) anchors each control step
(reuse mode) or each substep (exact mode) on a dynamics cache of the state:
FK, twist bases, inertia blocks, CRBA, the closed-form M^-1 and the contact
points (physics/envminor.cache_columns), and on a heightfield the height and
surface normal under each contact point (`Terrain.lookup`).  In the JAX
package that build is plain array code (physics/envminor.py
`build_cache_envminor`, reached through physics/engine.py
`build_pallas_env_inputs`), not a TPU kernel; its eager port,
`physics/engine.build_pallas_env_inputs`, is the plain version of this
launch and serves CPU tensors (`engine.build_dynamics_cache` takes it
there).  On a CUDA device `entry_cache` launches the hand-written kernel,
one warp per env (`team_entry_cache` of csrc/wtw_team.cuh, the statements
of the team control-step kernel's own entry-cache build), or raises: there
is no fallback.  `launches` (flat ground) and `normal_launches` (a
heightfield sampled in the launch) count kernel launches and nothing else.
"""
from __future__ import annotations

import numpy as np
import torch

from ..physics import envminor
from . import _build
from . import contact as pc
from . import megastep as pm

# number of times `entry_cache` launched the CUDA kernel: flat ground, and a
# heightfield sampled under the contact points
launches = 0
normal_launches = 0

_COUNTS = (7, 10, 3)


def library_spec(model):
    """What `_build.build_libraries` needs to build csrc/entry_cache.cu:
    the topology and model tables of the team control-step kernel's
    header (the cache build reads the model's constants)."""
    return ("entry_cache", pm.topology_header(model, 32, 6), _COUNTS)


def build_library(model):
    """Compile csrc/entry_cache.cu for sm_90a (once per model and source)
    and load it.  Raises on any failure."""
    return _build.build_library(*library_spec(model))


def _heightfield(terrain) -> bool:
    return terrain is not None and tuple(terrain.height.shape) != (2, 2)


def kernel_operands(model, state, dyn, terrain, block: int):
    """The arguments of `entry_cache_launch`: the state and the randomised
    payload and COM shift transposed to env-minor and padded to a multiple
    of `block` (input pointers in InIdx order, the radii and the heightfield
    null on flat ground), the output tensors in OutIdx order (Sw, Sv, A, B,
    m, M^-1, r, p_cp, then rh and n on a heightfield, else None), the
    floats, the ints, and the input tensors made here, which must outlive
    the launch.  Checks every operand."""
    dev = state.base_pos.device
    N = state.base_pos.shape[0]
    nv, nb = model.nv, model.nb
    P = model.cp_body.shape[0]
    hf = _heightfield(terrain)
    ins = [("q_t", pc.to_env_minor(state.q, block)),
           ("quat_t", pc.to_env_minor(state.base_quat, block)),
           ("pos_t", pc.to_env_minor(state.base_pos, block)),
           ("payload_t", pc.to_env_minor(dyn.payload[:, None], block)),
           ("comdisp_t", pc.to_env_minor(dyn.com_displacement, block))]
    Npad = ins[0][1].shape[-1]
    if Npad % pm.TEAM_ENVS:
        raise ValueError(f"entry_cache: {Npad} padded envs, not a multiple "
                         f"of {pm.TEAM_ENVS}")
    shapes = dict(q_t=(model.nj, Npad), quat_t=(4, Npad), pos_t=(3, Npad),
                  payload_t=(1, Npad), comdisp_t=(3, Npad))
    ptrs = [_build.check(n, x, shapes[n], dev).data_ptr() for n, x in ins]
    keep = [x for _, x in ins]
    hs, ox, oy, c_rows, c_cols = 1.0, 0.0, 0.0, 0, 0
    if hf:
        radius = torch.tensor(np.asarray(model.cp_radius), dtype=torch.float32,
                              device=dev)[:, None].contiguous()
        keep.append(radius)
        c_rows, c_cols = (int(x) for x in terrain.corners.shape[:2])
        ptrs += [radius.data_ptr(),
                 _build.check("corners", terrain.corners, (c_rows, c_cols, 4),
                              dev).data_ptr()]
        hs = terrain.horizontal_scale
        ox, oy = terrain.origin_xy
    else:
        ptrs += [None, None]
    shapes_out = [(nv, 3, Npad), (nv, 3, Npad), (nb, 9, Npad), (nb, 9, Npad),
                  (nb, Npad), (nv, nv, Npad), (P, 3, Npad), (P, 3, Npad)]
    if hf:
        shapes_out += [(P, Npad), (P, 3, Npad)]
    outs = [torch.empty(s, dtype=torch.float32, device=dev)
            for s in shapes_out] + [None] * (10 - len(shapes_out))
    ints = (Npad, N, pm.TEAM_THREADS, not hf, c_rows, c_cols)
    return ptrs, outs, (hs, ox, oy), ints, keep


def entry_cache(model, state, dyn, terrain, block: int):
    """The per-substep route's entry cache of `state` (a PhysicsState, env
    batch leading) with the randomised payload and COM shift of `dyn`, on
    `terrain`, env-minor and padded to a multiple of `block`: returns
    (EnvMinorCache, rh_t (P, Npad) = h + radius or None, n_t (P, 3, Npad)
    or None), the last two sampled at the contact points on a heightfield;
    the padded env lanes hold zeros and n = +z, as in
    `physics/engine.build_pallas_env_inputs`, which is the plain version
    and which `engine.build_dynamics_cache` calls for CPU tensors.

    Tensors on a CUDA device only: the kernel of csrc/entry_cache.cu,
    launched on the current stream without synchronising, outputs
    allocated here.  Any other device, and a failed build or launch,
    raises."""
    global launches, normal_launches
    dev = state.base_pos.device
    if dev.type != "cuda":
        raise ValueError(f"entry_cache: unsupported device {dev} (the plain "
                         "version is physics/engine.build_pallas_env_inputs)")
    ptrs, outs, floats, ints, keep = kernel_operands(model, state, dyn,
                                                     terrain, block)
    lib = build_library(model)
    with torch.cuda.device(dev):
        _build.launch(lib, "entry_cache", ptrs, outs, floats, ints,
                      torch.cuda.current_stream(dev).cuda_stream)
    del keep                      # freed in stream order, after the launch
    if _heightfield(terrain):
        normal_launches += 1
    else:
        launches += 1
    return unpack(outs)


def unpack(outs):
    """(EnvMinorCache, rh_t or None, n_t or None) from the launch's output
    tensors in OutIdx order."""
    Sw, Sv, A, B, m, Minv, r, pcp, rh, n = outs
    em = envminor.EnvMinorCache(Sw_t=Sw, Sv_t=Sv, Minv_t=Minv, A_t=A, B_t=B,
                                m_t=m, r_t=r, p_cp_t=pcp)
    return em, rh, n


def work_per_env(model, flat: bool = True):
    """(bytes moved, fp32 operations) per env of `entry_cache`: the joint
    angles, quaternion, base position, payload and COM shift read once
    (on a heightfield also one cell of four corner heights per contact
    point), the cache (Sw, Sv, A, B, m, M^-1, r, p_cp; on a heightfield rh
    and n) written once; operations: the cache build of the team kernel's
    entry cache (`ops/megastep.cache_rebuild_ops`), r = p_cp - pos, and on
    a heightfield one sample per contact point
    (`ops/megastep.HEIGHTFIELD_SAMPLE_OPS`, h + radius included)."""
    nv, nb, nj = model.nv, model.nb, model.nj
    P = model.cp_body.shape[0]
    floats_in = nj + 4 + 3 + 1 + 3 + (0 if flat else 4 * P)
    floats_out = (2 * nv * 3 + 2 * nb * 9 + nb + nv * nv + 2 * P * 3
                  + (0 if flat else P + 3 * P))
    ops = pm.cache_rebuild_ops(model) + 3 * P
    if not flat:
        ops += P * pm.HEIGHTFIELD_SAMPLE_OPS
    return 4 * (floats_in + floats_out), ops
