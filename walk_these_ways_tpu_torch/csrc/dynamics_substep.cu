// Full cached physics substep for Hopper (sm_90a): unconstrained dynamics
// with the midpoint rule, then the contact pipeline, in one launch.
//
// Replaces: the JAX package's ops/pallas_dynamics.py::_dyn_substep_kernel
// (the TPU kernel reached through dynamics_substep_pallas; bodies dyn_core
// twice + contact_core) in its two variants (template flag NORMALS):
//   K3   flat ground (n = +z);
//   K3b  a heightfield: the per-point surface normals (P, 3) are an operand
//        and the contact solve takes its general-normal rows.
//
// What it computes, per env (envs are independent):
//   qdd1    = dyn(gv)                 body twists over the static ancestor
//   qdd     = dyn(gv + dt/2 qdd1)     mask, RNEA bias in 3x3 block form,
//   gv_free = gv + dt qdd             M^-1 (tau - bias) + centripetal rows
//   then, with contact on, the contact solve and point advance of
//   wtw_contact.cuh on gv_free (K3b: with the normals); with contact off
//   gv_free, the points unchanged and zero impulses.
//
// Design for this card.  One thread owns one env and runs the whole scalar
// program; operands are env-minor, so a warp's load is one coalesced line.
// The twist bases (2 x nv x 3 floats) are loaded once into thread-local
// memory for both dynamics evaluations; M^-1 and the inertia blocks stay in
// global memory and are re-read through the read-only path.  The point
// Jacobian is an input (built by the contact-cache kernel) and is read from
// global memory once per sweep; the robot's static topology from the
// generated header lets a point read only the six base columns and its own
// leg's columns (9 of 18 for a leg point, 6 for a trunk point).
//
// Bound on this card: about 11 KB per env moved (J is most of it; K3b adds
// the normals and W's five other entries) against about 0.08 MFLOP (K3b:
// about 0.1), so the least time is set by bytes.  K3b reads a point's
// normal and its nine W entries from global memory in every sweep rather
// than holding them per thread.  One thread per env
// is about one warp per SM at 4096 envs: as written the kernel waits on
// instruction and load latency, far above that least time; measured numbers
// are kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_device.cuh"
#include "wtw_contact.cuh"

enum InIdx { I_SW = 0, I_SV, I_A, I_B, I_M, I_MINV, I_G, I_TAU, I_GV, I_J,
             I_W, I_PCP, I_RH, I_MU, I_E, I_VLIM, I_N, N_IN };
enum OutIdx { O_GV = 0, O_PCP, O_LAM, N_OUT };
enum FIdx { F_DT = 0, F_RELAX, F_BAUM_DT, F_SLOP, F_MAXDEPEN, F_BOUNCE,
            F_HALFDT, N_F };

struct DynSubstepArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  ContactParams c;
  float half_dt;
  int npad, contact;
};

template <bool NORMALS>
__global__ void __launch_bounds__(128)
dynamics_substep_kernel(const DynSubstepArgs a) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= a.npad) return;          // ragged edge of the last block
  const size_t npad = (size_t)a.npad;
#define LD(idx, row) __ldg(a.in[idx] + (size_t)(row) * npad + env)

  float sw[NV][3], sv[NV][3];
#pragma unroll 1
  for (int d = 0; d < NV; ++d)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sw[d][i] = LD(I_SW, d * 3 + i);
      sv[d][i] = LD(I_SV, d * 3 + i);
    }
  float tau[NV], gv[NV], qdd[NV], gvm[NV], g[3];
#pragma unroll
  for (int v = 0; v < NV; ++v) { tau[v] = LD(I_TAU, v); gv[v] = LD(I_GV, v); }
#pragma unroll
  for (int i = 0; i < 3; ++i) g[i] = LD(I_G, i);

  // unconstrained dynamics, midpoint rule on the velocity-product terms
  const EnvRows rA{a.in[I_A], npad, env}, rB{a.in[I_B], npad, env},
      rM{a.in[I_M], npad, env}, rMinv{a.in[I_MINV], npad, env};
  dyn_core(sw, sv, rA, rB, rM, rMinv, g, tau, gv, qdd);
#pragma unroll
  for (int v = 0; v < NV; ++v) gvm[v] = gv[v] + a.half_dt * qdd[v];
  dyn_core(sw, sv, rA, rB, rM, rMinv, g, tau, gvm, qdd);
#pragma unroll
  for (int v = 0; v < NV; ++v) gv[v] = gv[v] + a.c.dt * qdd[v];   // gv_free

  if (a.contact) {
    contact_core_dev<true, NORMALS>(
        a.in[I_J], a.in[I_W], a.in[I_MINV], a.in[I_PCP], a.in[I_RH],
        a.in[I_VLIM], a.in[I_N], LD(I_MU, 0), LD(I_E, 0), a.c, gv,
        a.out[O_PCP], a.out[O_LAM], npad, env);
  } else {
#pragma unroll 1
    for (int k = 0; k < NP * 3; ++k) {
      a.out[O_PCP][(size_t)k * npad + env] = LD(I_PCP, k);
      a.out[O_LAM][(size_t)k * npad + env] = 0.0f;
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) a.out[O_GV][(size_t)v * npad + env] = gv[v];
#undef LD
}

// Plain C interface for ctypes.  `in` = {Sw, Sv (nv, 3, npad), A, B (nb, 9,
// npad), m (nb, npad), Minv (nv, nv, npad), g (3, npad), tau, gv (nv, npad),
// J (P, 3, nv, npad), W (P, 9, npad), p_cp (P, 3, npad), rh (P, npad),
// mu, e (1, npad), vlim (nv, 1), n (P, 3, npad) or null on flat ground},
// `out` = {gv (nv, npad), p_cp, lam (P, 3, npad)}, `f` the FIdx scalars,
// `ip` = {npad, num_iters, contact, threads per block, normals}.  Launches
// on `stream`, does not synchronise, returns the launch's cudaError_t (0 =
// launched).
extern "C" int dynamics_substep_launch(const void* const* in,
                                       void* const* out, const float* f,
                                       const int* ip, void* stream) {
  DynSubstepArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  a.c.dt = f[F_DT]; a.c.relax = f[F_RELAX]; a.c.baum_dt = f[F_BAUM_DT];
  a.c.slop = f[F_SLOP]; a.c.max_depen = f[F_MAXDEPEN];
  a.c.bounce = f[F_BOUNCE];
  a.half_dt = f[F_HALFDT];
  a.npad = ip[0]; a.c.num_iters = ip[1]; a.contact = ip[2];
  const int threads = ip[3], normals = ip[4];
  if (threads < 1 || threads > 128 || a.npad < 1 || a.c.num_iters < 0
      || (normals && a.in[I_N] == nullptr))
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.npad + threads - 1) / threads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (normals)
    dynamics_substep_kernel<true><<<blocks, threads, 0, st>>>(a);
  else
    dynamics_substep_kernel<false><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dynamics_substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int dynamics_substep_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}
