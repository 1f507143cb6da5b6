// Exact-mode dynamics cache for one env, rebuilt on thread-local arrays:
// FK over the static tree -> twist bases -> spatial inertia blocks -> CRBA over
// the static sparsity -> closed-form M^-1 (per-leg 3x3 blocks + 6x6 Schur
// complement) -> contact points.
//
// Replaces, inside the control-step kernel (csrc/megastep.cu, EXACT
// instantiation): the JAX package's physics/envminor.cache_columns and
// _mass_matrix_inverse_scalar as the TPU kernel ops/pallas_megastep.py
// reaches them through _cache_arrays.  Its plain counterpart in this port is
// physics/envminor.cache_columns; the statements below follow it one for one
// (same association of sums, same eps), so the two differ by the float32
// library functions (sinf, cosf) only: the kernels are built without fused
// multiply-adds (ops/_build.py).
//
// csrc/megastep_team.cu team_entry_cache runs the same statements spread
// over a warp's lanes, once per launch, for K4 and K4b: a change here is
// made there too (the two are held against the same plain version).
//
// Needs the generated header's model tables (MS_HAVE_MODEL: ops/_build.py
// model_tables).  Quadruped topology: a floating base and legs of three
// revolute joints each, dofs of one leg contiguous.
//
// Outputs, all per thread: sw, sv (NV x 3 twist bases, rows 0..5 the unit root
// twists), A, B (NB x 9, row-major 3x3 blocks: A = I_w - m [r]x[r]x,
// B = m [r]x with r = com - ref), mass (NB), Minv (NV x NV, row-major) and
// pcp (NP x 3 contact points, world).  About 900 floats of temporaries live in
// this function's frame (local memory).
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

__device__ __noinline__ void cache_columns_dev(
    const float* q, const float* quat, const float* ref, float payload,
    const float* comdisp, float (*sw)[3], float (*sv)[3], float* A, float* B,
    float* mass, float* Minv, float (*pcp)[3]) {
  // ---- FK: base pose, then the joints parent before child ----
  float R[NB][9], p[NB][3], axw[NJ][3], anw[NJ][3];
  {
    const float qx = quat[0], qy = quat[1], qz = quat[2], qw = quat[3];
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    R[0][0] = 1 - 2 * (yy + zz); R[0][1] = 2 * (xy - wz);
    R[0][2] = 2 * (xz + wy);     R[0][3] = 2 * (xy + wz);
    R[0][4] = 1 - 2 * (xx + zz); R[0][5] = 2 * (yz - wx);
    R[0][6] = 2 * (xz - wy);     R[0][7] = 2 * (yz + wx);
    R[0][8] = 1 - 2 * (xx + yy);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[0][i] = ref[i];
  }
#pragma unroll 1
  for (int k = 0; k < NJ; ++k) {
    const int j = MS_FK_ORDER[k];
    const int b = MS_JOINT_BODY[j], pb = MS_PARENT[b];
    const float s = sinf(q[j]), c1 = 1.0f - cosf(q[j]);
    float rot[9], an[3], ax[3];
#pragma unroll
    for (int e = 0; e < 9; ++e)
      rot[e] = ((e % 4 == 0 ? 1.0f : 0.0f) + MS_JOINT_K[9 * j + e] * s)
             + MS_JOINT_KK[9 * j + e] * c1;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      an[i] = MS_JOINT_ANCHOR[3 * j + i];
      ax[i] = MS_JOINT_AXIS[3 * j + i];
    }
    float t[3];
    m3v(R[pb], an, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) anw[j][i] = p[pb][i] + t[i];
    m3v(R[pb], ax, axw[j]);
    m3mul(R[pb], rot, R[b]);
#pragma unroll
    for (int i = 0; i < 3; ++i) p[b][i] = anw[j][i];
  }

  // ---- twist bases ----
#pragma unroll
  for (int d = 0; d < 6; ++d)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sw[d][i] = (d == i) ? 1.0f : 0.0f;
      sv[d][i] = (d == 3 + i) ? 1.0f : 0.0f;
    }
#pragma unroll 1
  for (int j = 0; j < NJ; ++j) {
    float dr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      sw[6 + j][i] = axw[j][i];
      dr[i] = anw[j][i] - ref[i];
    }
    cross3(dr, axw[j], sv[6 + j]);
  }

  // ---- spatial inertia blocks about ref ----
  float com[NB][3];
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    mass[b] = MS_MASS[b];
    float c[3] = {MS_COM[3 * b], MS_COM[3 * b + 1], MS_COM[3 * b + 2]}, t[3];
    m3v(R[b], c, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) com[b][i] = p[b][i] + t[i];
  }
  mass[0] = mass[0] + payload;
  {
    float t[3];
    m3v(R[0], comdisp, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) com[0][i] = com[0][i] + t[i];
  }
  // the base's rotational inertia scales with its mass, payload included
  const float scale0 = mass[0] / MS_MASS[0];
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    float Il[9], t[9], Iw[9], rx[9], mrx[9], mrxrx[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      Il[k] = b == 0 ? MS_INERTIA[9 * b + k] * scale0 : MS_INERTIA[9 * b + k];
    m3mul_bt(Il, R[b], t);                // I_l R^T
    m3mul(R[b], t, Iw);                   // R (I_l R^T)
    const float r0 = com[b][0] - ref[0], r1 = com[b][1] - ref[1],
                r2 = com[b][2] - ref[2];
    rx[0] = 0.0f; rx[1] = -r2;  rx[2] = r1;
    rx[3] = r2;   rx[4] = 0.0f; rx[5] = -r0;
    rx[6] = -r1;  rx[7] = r0;   rx[8] = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) mrx[k] = mass[b] * rx[k];
    m3mul(mrx, rx, mrxrx);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      A[9 * b + k] = Iw[k] - mrxrx[k];
      B[9 * b + k] = mrx[k];
    }
  }

  // ---- CRBA over the static sparsity: M, then +1e-7 on its diagonal ----
  float M[NV * NV];
#pragma unroll 1
  for (int k = 0; k < NV * NV; ++k) M[k] = 0.0f;
  {
    float At[9], Bt[9], mt = mass[0];
#pragma unroll
    for (int k = 0; k < 9; ++k) { At[k] = A[k]; Bt[k] = B[k]; }
#pragma unroll 1
    for (int b = 1; b < NB; ++b) {
#pragma unroll
      for (int k = 0; k < 9; ++k) { At[k] += A[9 * b + k]; Bt[k] += B[9 * b + k]; }
      mt = mt + mass[b];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        M[i * NV + j] = At[3 * i + j];
        M[i * NV + 3 + j] = Bt[3 * i + j];
        M[(3 + i) * NV + j] = Bt[3 * j + i];
      }
      M[(3 + i) * NV + 3 + i] = mt;
    }
  }
  float ca[NJ][3], cb[NJ][3];           // composite-inertia columns
#pragma unroll 1
  for (int j = 0; j < NJ; ++j) {
    float Ac[9], Bc[9], mc = 0.0f;
    bool first = true;
#pragma unroll 1
    for (int b = 0; b < NB; ++b) {
      if (!MS_ANC[(6 + j) * NB + b]) continue;
      if (first) {
#pragma unroll
        for (int k = 0; k < 9; ++k) { Ac[k] = A[9 * b + k]; Bc[k] = B[9 * b + k]; }
        mc = mass[b];
        first = false;
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) { Ac[k] += A[9 * b + k]; Bc[k] += B[9 * b + k]; }
        mc = mc + mass[b];
      }
    }
    float t1[3], t2[3];
    m3v(Ac, sw[6 + j], t1);
    m3v(Bc, sv[6 + j], t2);
#pragma unroll
    for (int i = 0; i < 3; ++i) ca[j][i] = t1[i] + t2[i];
    m3tv(Bc, sw[6 + j], t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cb[j][i] = t1[i] + mc * sv[6 + j][i];
      M[i * NV + 6 + j] = ca[j][i];
      M[(6 + j) * NV + i] = ca[j][i];
      M[(3 + i) * NV + 6 + j] = cb[j][i];
      M[(6 + j) * NV + 3 + i] = cb[j][i];
    }
  }
#pragma unroll 1
  for (int i = 0; i < NJ; ++i)
#pragma unroll 1
    for (int j = 0; j < NJ; ++j) {
      // nonzero iff dof i is an ancestor of (or equals) dof j
      if (!MS_JJ_SUB[i * NJ + j]) continue;
      const float val = (sw[6 + i][0] * ca[j][0] + sw[6 + i][1] * ca[j][1]
                         + sw[6 + i][2] * ca[j][2])
                      + (sv[6 + i][0] * cb[j][0] + sv[6 + i][1] * cb[j][1]
                         + sv[6 + i][2] * cb[j][2]);
      M[(6 + i) * NV + 6 + j] = val;
      M[(6 + j) * NV + 6 + i] = val;
    }
#pragma unroll 1
  for (int i = 0; i < NV; ++i) M[i * NV + i] += 1e-7f;

  // ---- closed-form M^-1: per-leg 3x3 blocks D, 6x6 Schur complement ----
  const float eps = 1e-8f;
  constexpr int NL = NJ / 3;
  float Dinv[NL][9], BD[6][NJ], S[36], Sinv[36], T[6][NJ];
#pragma unroll 1
  for (int c = 0; c < NL; ++c) {
    const int o = 6 + 3 * c;
    float Dc[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Dc[3 * i + j] = M[(o + i) * NV + o + j];
    inv3_eps(Dc, eps, Dinv[c]);
  }
#pragma unroll 1
  for (int i = 0; i < 6; ++i)
#pragma unroll 1
    for (int c = 0; c < NL; ++c)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float* Bi = M + i * NV + 6 + 3 * c;   // B6[i][3c + k]
        BD[i][3 * c + j] = Bi[0] * Dinv[c][j] + Bi[1] * Dinv[c][3 + j]
                         + Bi[2] * Dinv[c][6 + j];
      }
#pragma unroll 1
  for (int i = 0; i < 6; ++i)
#pragma unroll 1
    for (int j = 0; j < 6; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < NJ; ++k) acc += BD[i][k] * M[j * NV + 6 + k];
      S[6 * i + j] = M[i * NV + j] - acc;
    }
  inv_spd6(S, eps, Sinv);
#pragma unroll 1
  for (int i = 0; i < 6; ++i)
#pragma unroll 1
    for (int j = 0; j < NJ; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += Sinv[6 * i + k] * BD[k][j];
      T[i][j] = acc;
    }
#pragma unroll 1
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) Minv[i * NV + j] = Sinv[6 * i + j];
#pragma unroll 1
    for (int j = 0; j < NJ; ++j) {
      Minv[i * NV + 6 + j] = -T[i][j];
      Minv[(6 + j) * NV + i] = -T[i][j];
    }
  }
#pragma unroll 1
  for (int i = 0; i < NJ; ++i)
#pragma unroll 1
    for (int j = 0; j < NJ; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += BD[k][i] * T[k][j];
      const float d = (i / 3 == j / 3) ? Dinv[i / 3][3 * (i % 3) + j % 3]
                                       : 0.0f;
      Minv[(6 + i) * NV + 6 + j] = d + acc;
    }

  // ---- contact points ----
#pragma unroll 1
  for (int pt = 0; pt < NP; ++pt) {
    const int b = MS_CP_BODY[pt];
    float off[3] = {MS_CP_OFFSET[3 * pt], MS_CP_OFFSET[3 * pt + 1],
                    MS_CP_OFFSET[3 * pt + 2]}, t[3];
    m3v(R[b], off, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) pcp[pt][i] = p[b][i] + t[i];
  }
}

#endif  // MS_HAVE_MODEL
