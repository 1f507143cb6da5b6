// Contact-substep kernel for Hopper (sm_90a): one physics substep's contact
// pipeline on cached point Jacobians.
//
// Replaces: the JAX package's ops/pallas_contact.py::_substep_kernel (the TPU
// kernel reached through contact_substep_pallas; body contact_core, which
// that kernel calls on flat ground only: no normal operand).
//
// What it computes, per env (envs are independent): contact gaps from the
// carried contact points, restitution / capped-Baumgarte velocity targets,
// `num_iters` row-decoupled projected-Jacobi sweeps from a cold start (normal
// row to its target, friction row opposite the slip with scalar mass t^T W t,
// clamp to the mu * lambda_n cone), gv += M^-1 J^T dlam after each sweep, and
// the point advance p' = p + dt J clip(gv).  See wtw_contact.cuh.
//
// Design for this card.  One thread owns one env; operands are env-minor, so
// each load of a warp is one coalesced 128-byte line.  J (P*3*nv floats per
// env) is an input here and stays in global memory: every sweep reads it once
// (at 4096 envs it is 25 MB and stays in the 50 MB L2 between sweeps), and a
// point's rows serve both J_p gv and J_p^T dlam.  The kernel is given no
// robot topology, so every point is taken over all nv dofs, as the TPU kernel
// takes it.  Impulses, targets and the W entries the rows need stay in
// thread-local memory.
//
// Bound on this card: J, W, M^-1, the points and velocities read once, gv,
// points and impulses written once — about 9.6 KB per env against about
// 0.13 MFLOP, so the least time is set by bytes.  One thread per env is about
// one warp per SM at 4096 envs: as written the kernel waits on load latency,
// far above that least time; measured numbers are kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_device.cuh"
#include "wtw_contact.cuh"

enum InIdx { I_J = 0, I_W, I_MINV, I_PCP, I_GV, I_RH, I_MU, I_E, I_VLIM,
             N_IN };
enum OutIdx { O_GV = 0, O_PCP, O_LAM, N_OUT };
enum FIdx { F_DT = 0, F_RELAX, F_BAUM_DT, F_SLOP, F_MAXDEPEN, F_BOUNCE, N_F };

struct SubstepArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  ContactParams c;
  int npad;
};

__global__ void __launch_bounds__(128)
contact_substep_kernel(const SubstepArgs a) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  if (env >= a.npad) return;          // ragged edge of the last block
  const size_t npad = (size_t)a.npad;
  float gv[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v)
    gv[v] = __ldg(a.in[I_GV] + (size_t)v * npad + env);
  contact_core_dev<false, false>(
      a.in[I_J], a.in[I_W], a.in[I_MINV], a.in[I_PCP], a.in[I_RH],
      a.in[I_VLIM], nullptr, __ldg(a.in[I_MU] + env), __ldg(a.in[I_E] + env),
      a.c, gv, a.out[O_PCP], a.out[O_LAM], npad, env);
#pragma unroll
  for (int v = 0; v < NV; ++v) a.out[O_GV][(size_t)v * npad + env] = gv[v];
}

// Plain C interface for ctypes.  `in` = {J (P, 3, nv, npad), W (P, 9, npad),
// Minv (nv, nv, npad), p_cp (P, 3, npad), gv (nv, npad), rh (P, npad),
// mu (1, npad), e (1, npad), vlim (nv, 1)}, `out` = {gv (nv, npad),
// p_cp (P, 3, npad), lam (P, 3, npad)}, `f` the FIdx scalars,
// `ip` = {npad, num_iters, threads per block}.  Launches on `stream`, does
// not synchronise, returns the launch's cudaError_t (0 = launched).
extern "C" int contact_substep_launch(const void* const* in, void* const* out,
                                      const float* f, const int* ip,
                                      void* stream) {
  SubstepArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  a.c.dt = f[F_DT]; a.c.relax = f[F_RELAX]; a.c.baum_dt = f[F_BAUM_DT];
  a.c.slop = f[F_SLOP]; a.c.max_depen = f[F_MAXDEPEN];
  a.c.bounce = f[F_BOUNCE];
  a.npad = ip[0]; a.c.num_iters = ip[1];
  const int threads = ip[2];
  if (threads < 1 || threads > 128 || a.npad < 1 || a.c.num_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (a.npad + threads - 1) / threads;
  contact_substep_kernel<<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* contact_substep_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int contact_substep_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}
