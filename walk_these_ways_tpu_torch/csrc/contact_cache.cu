// Contact-cache kernel for Hopper (sm_90a): point Jacobians and 3x3
// effective-mass matrices, once per control step.
//
// Replaces: the JAX package's ops/pallas_contact.py::_cache_kernel (the TPU
// kernel reached through build_contact_cache_pallas; body cache_core).
//
// What it computes, per env and contact point p:
//   J[p,i,v] = anc[p,v] * (Sv[v,i] + (Sw[v] x r[p])[i])
//   W_p      = J_p M^-1 J_p^T + eps I          (9 rows, row-major)
//
// Design for this card.  One thread owns one (env, point) pair: the grid is
// (env blocks, points), so at 4096 envs there are 28 x 4096 threads instead of
// 4096, enough warps to hide the latency of the loads.  Every operand is
// env-minor, so a warp reads and writes 32 neighbouring floats.  The point's
// 3 x nv Jacobian rows live in thread-local memory while the thread forms
// t_i = J_i M^-1 one row at a time; the ancestor mask is read at one address
// by the whole warp (a broadcast), and columns it zeroes are skipped in the
// products (they add exact zeros).  Sw, Sv and M^-1 are read by all 28
// threads of an env: the first read comes from device memory, the rest from
// L2.
//
// Bound on this card: the dense J (P*3*nv floats per env) and W (P*9) must be
// written once, and Sw, Sv, M^-1, r read once: about 9.1 KB per env against
// about 0.02 MFLOP, so the least time is set by bytes.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_device.cuh"

enum InIdx { I_ANC = 0, I_SW, I_SV, I_MINV, I_R, N_IN };
enum OutIdx { O_J = 0, O_W, N_OUT };
enum FIdx { F_EPS = 0, N_F };

struct CacheArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  float eps;
  int npad;
};

__global__ void __launch_bounds__(256)
contact_cache_kernel(const CacheArgs a) {
  const int env = blockIdx.x * blockDim.x + threadIdx.x;
  const int p = blockIdx.y;
  if (env >= a.npad) return;          // ragged edge of the last block
  const size_t npad = (size_t)a.npad;
  const float* anc = a.in[I_ANC] + p * NV;      // same address for the warp
  const float* Minv = a.in[I_MINV];

  float r[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    r[i] = __ldg(a.in[I_R] + (size_t)(p * 3 + i) * npad + env);

  // J rows of this point, written out as they are made
  float Jp[3][NV];
#pragma unroll 1
  for (int v = 0; v < NV; ++v) {
    const float m = __ldg(anc + v);
    float sw[3], sv[3], c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sw[i] = __ldg(a.in[I_SW] + (size_t)(v * 3 + i) * npad + env);
      sv[i] = __ldg(a.in[I_SV] + (size_t)(v * 3 + i) * npad + env);
    }
    cross3(sw, r, c);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float j = m * (sv[i] + c[i]);
      Jp[i][v] = j;
      a.out[O_J][((size_t)(p * 3 + i) * NV + v) * npad + env] = j;
    }
  }

  // W[i][j] = sum_v J[j][v] t_i[v],  t_i[v] = sum_w J[i][w] Minv[w][v]
#pragma unroll 1
  for (int i = 0; i < 3; ++i) {
    float t[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) t[v] = 0.0f;
#pragma unroll 1
    for (int w = 0; w < NV; ++w) {
      if (__ldg(anc + w) == 0.0f) continue;     // J[i][w] is an exact zero
      const float jw = Jp[i][w];
      const float* row = Minv + (size_t)(w * NV) * npad + env;
#pragma unroll
      for (int v = 0; v < NV; ++v) t[v] += jw * __ldg(row + (size_t)v * npad);
    }
    float w0 = 0.0f, w1 = 0.0f, w2 = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      w0 += Jp[0][v] * t[v]; w1 += Jp[1][v] * t[v]; w2 += Jp[2][v] * t[v];
    }
    if (i == 0) w0 += a.eps;
    if (i == 1) w1 += a.eps;
    if (i == 2) w2 += a.eps;
    float* Wp = a.out[O_W] + (size_t)(p * 9 + i * 3) * npad + env;
    Wp[0] = w0; Wp[npad] = w1; Wp[2 * npad] = w2;
  }
}

// Plain C interface for ctypes.  `in` = {anc (P, nv), Sw (nv, 3, npad),
// Sv (nv, 3, npad), Minv (nv, nv, npad), r (P, 3, npad)}, `out` = {J (P, 3,
// nv, npad), W (P, 9, npad)}, `f` = {eps}, `ip` = {npad, threads per block}.
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t (0 = launched).
extern "C" int contact_cache_launch(const void* const* in, void* const* out,
                                    const float* f, const int* ip,
                                    void* stream) {
  CacheArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  a.eps = f[F_EPS];
  a.npad = ip[0];
  const int threads = ip[1];
  if (threads < 1 || threads > 256 || a.npad < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((a.npad + threads - 1) / threads, NP);
  contact_cache_kernel<<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* contact_cache_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int contact_cache_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}
