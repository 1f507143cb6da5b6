// The 3x3 and 6x6 helpers of the in-kernel dynamics cache build
// (csrc/wtw_team.cuh team_entry_cache, run by csrc/megastep_team.cu and
// csrc/entry_cache.cu): products of row-major 3x3 matrices, the adjugate
// inverse of A + eps I and the inverse of an SPD 6x6 matrix by its 3x3
// Schur complement.  They replace, inside those kernels, the JAX package's
// physics/envminor._inv3 and _inv_spd6 as the TPU kernel
// ops/pallas_megastep.py reaches them through _cache_arrays; their plain
// counterparts in this port are physics/envminor's, statement for
// statement (same association of sums, same eps): the kernels are built
// without fused multiply-adds (ops/_build.py).
//
// Needs the generated header's model tables (MS_HAVE_MODEL: ops/_build.py
// model_tables).
#pragma once
#include "wtw_device.cuh"

#ifdef MS_HAVE_MODEL

// C = A B, row-major 3x3
__device__ __forceinline__ void m3mul(const float* A, const float* B,
                                      float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j]
                   + A[3 * i + 2] * B[6 + j];
}

// C = A B^T
__device__ __forceinline__ void m3mul_bt(const float* A, const float* B,
                                         float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1]
                   + A[3 * i + 2] * B[3 * j + 2];
}

// C = A^T B
__device__ __forceinline__ void m3mul_at(const float* A, const float* B,
                                         float* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[i] * B[j] + A[3 + i] * B[3 + j] + A[6 + i] * B[6 + j];
}

// adjugate inverse of A + eps I (physics/envminor._inv3)
__device__ __forceinline__ void inv3_eps(const float* A, float eps,
                                         float* o) {
  const float a = A[0] + eps, b = A[1], c = A[2];
  const float d = A[3], e = A[4] + eps, f = A[5];
  const float g = A[6], h = A[7], i = A[8] + eps;
  const float cA = e * i - f * h, cB = -(d * i - f * g), cC = d * h - e * g;
  const float cD = -(b * i - c * h), cE = a * i - c * g, cF = -(a * h - b * g);
  const float cG = b * f - c * e, cH = -(a * f - c * d), cI = a * e - b * d;
  const float inv_det = 1.0f / (a * cA + b * cB + c * cC);
  o[0] = cA * inv_det; o[1] = cD * inv_det; o[2] = cG * inv_det;
  o[3] = cB * inv_det; o[4] = cE * inv_det; o[5] = cH * inv_det;
  o[6] = cC * inv_det; o[7] = cF * inv_det; o[8] = cI * inv_det;
}

// inverse of the SPD 6x6 S (row-major) by its 3x3 Schur complement
// (physics/envminor._inv_spd6)
__device__ __forceinline__ void inv_spd6(const float* S, float eps,
                                         float* out) {
  float P[9], Q[9], R[9];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      P[3 * i + j] = S[6 * i + j];
      Q[3 * i + j] = S[6 * i + 3 + j];
      R[3 * i + j] = S[6 * (3 + i) + 3 + j];
    }
  float Pinv[9], PiQ[9], QtPiQ[9], Sc[9], Sinv[9], t[9], TL[9];
  inv3_eps(P, eps, Pinv);
  m3mul(Pinv, Q, PiQ);
  m3mul_at(Q, PiQ, QtPiQ);
#pragma unroll
  for (int k = 0; k < 9; ++k) Sc[k] = R[k] - QtPiQ[k];
  inv3_eps(Sc, eps, Sinv);
  m3mul_bt(Sinv, PiQ, t);                 // Sinv PiQ^T
  m3mul(PiQ, t, TL);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float tr = -(PiQ[3 * i] * Sinv[j] + PiQ[3 * i + 1] * Sinv[3 + j]
                         + PiQ[3 * i + 2] * Sinv[6 + j]);
      out[6 * i + j] = Pinv[3 * i + j] + TL[3 * i + j];
      out[6 * i + 3 + j] = tr;
      out[6 * (3 + j) + i] = tr;
      out[6 * (3 + i) + 3 + j] = Sinv[3 * i + j];
    }
}

#endif  // MS_HAVE_MODEL
