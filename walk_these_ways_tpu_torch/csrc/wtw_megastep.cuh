// What the two control-step kernels share: csrc/megastep.cu (one thread per
// env: K4c, K4b with P control, K5) and csrc/megastep_team.cu (one warp per
// env: K4, K4b with the actuator network).  Both take one argument list,
// packed by ops/megastep.kernel_operands, and both run the per-contact-point
// arithmetic below: a point's velocity from the kept Jacobian columns, its
// columns and effective-mass entries, and the flat-ground row update.
//
// Include after the generated "wtw_topology.h".
#pragma once
#include "wtw_device.cuh"

#define GM MS_GMAX
#define NH MS_H
#define NF MS_F

enum InIdx {
  I_SW = 0, I_SV, I_A, I_B, I_M, I_MINV, I_PCP, I_RH, I_MU, I_E, I_G,
  I_LAM, I_Q, I_QD, I_POS, I_QUAT, I_LIN, I_ANG, I_TGT, I_STR,
  I_W0, I_B0, I_W1, I_B1, I_W2, I_B2, I_EL, I_ELL, I_VL, I_VLL,
  I_VLIM, I_TLIM, I_QLO, I_QHI, I_KP, I_KD, I_PAYLOAD, I_COMDISP, I_N,
  I_CORNERS, I_NET, N_IN
};
enum OutIdx {
  O_Q = 0, O_QD, O_POS, O_QUAT, O_LIN, O_ANG, O_PCP, O_PCPPREV, O_LAM,
  O_TAU, O_EL, O_ELL, O_VL, O_VLL, N_OUT
};
enum FIdx {
  F_DT = 0, F_RELAX, F_BAUM_DT, F_SLOP, F_MAXDEPEN, F_BOUNCE, F_KLIM,
  F_DLIM, F_MAXANG, F_MAXLIN, F_EPS, F_HALFDT, F_HS, F_OX, F_OY, N_F
};
// the int scalars `ip` of both launchers
enum IntIdx {
  P_NPAD = 0, P_D, P_ITERS, P_WARM_ITERS, P_CONTACT, P_THREADS, P_PCTRL,
  P_EXACT, P_FLAT, P_ENTRY, P_CROWS, P_CCOLS, N_IP
};

struct MegastepArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  float f[N_F];
  int npad, D, num_iters, warm_iters, contact, c_rows, c_cols;
};

// The launchers' common part: pointers, scalars and the counts of the
// heightfield's cells.  `in` / `out` are host arrays of device pointers in
// InIdx / OutIdx order, `f` the FIdx scalars, `ip` the IntIdx ints.
inline MegastepArgs megastep_args(const void* const* in, void* const* out,
                                  const float* f, const int* ip) {
  MegastepArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  for (int i = 0; i < N_F; ++i) a.f[i] = f[i];
  a.npad = ip[P_NPAD]; a.D = ip[P_D]; a.num_iters = ip[P_ITERS];
  a.warm_iters = ip[P_WARM_ITERS]; a.contact = ip[P_CONTACT];
  a.c_rows = ip[P_CROWS]; a.c_cols = ip[P_CCOLS];
  return a;
}

// Velocity of a contact point: base part from r (unit root twists), leg
// part from its kept Jacobian columns Jl over its leg dofs lo .. lo + n.
__device__ __forceinline__ void point_velocity(const float* gv,
                                               const float* r,
                                               const float (*Jl)[3], int lo,
                                               int n, float* v) {
  float c[3];
  cross3(gv, r, c);
  v[0] = gv[3] + c[0]; v[1] = gv[4] + c[1]; v[2] = gv[5] + c[2];
  for (int k = 0; k < n; ++k) {
    const float s = gv[lo + k];
    v[0] += Jl[k][0] * s; v[1] += Jl[k][1] * s; v[2] += Jl[k][2] * s;
  }
}

// Contact point p about the anchor (r = p_cp - anchor): its leg-joint
// Jacobian columns Jl and the entries of W_p = J_p M^-1 J_p^T + eps I that
// the solve reads.  Flat ground: W00, W01, W11 and the normal row's
// relax / W22.  With the surface normal `nrm` (FLAT false): also W02, W12,
// W22 — W_p is symmetric — and relax / n^T W_p n.
template <bool FLAT, class Rows>
__device__ __forceinline__ void point_cache(
    int p, const Rows& Minv, const float (*sw)[3], const float (*sv)[3],
    const float* r, float (*Jl)[3], float& W00, float& W01, float& W11,
    float& W02, float& W12, float& W22, float& inv_wnn, const float* nrm,
    float eps, float relax) {
  const int lo = MS_PT_LO[p], n = MS_PT_N[p];
  // J rows of this point over its dofs: 6 base + n leg joints
  float Jp[6 + GM][3];
  Jp[0][0] = 0.0f;  Jp[0][1] = -r[2]; Jp[0][2] = r[1];
  Jp[1][0] = r[2];  Jp[1][1] = 0.0f;  Jp[1][2] = -r[0];
  Jp[2][0] = -r[1]; Jp[2][1] = r[0];  Jp[2][2] = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int i = 0; i < 3; ++i) Jp[3 + k][i] = (k == i) ? 1.0f : 0.0f;
  for (int k = 0; k < GM; ++k) {
    float c[3] = {0.0f, 0.0f, 0.0f};
    if (k < n) {
      cross3(sw[lo + k], r, c);
      const float mask = MS_PT_ANC[p * GM + k];
#pragma unroll
      for (int i = 0; i < 3; ++i) c[i] = mask * (sv[lo + k][i] + c[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) { Jl[k][i] = c[i]; Jp[6 + k][i] = c[i]; }
  }
  // W[i][j] = sum_v J[j][v] * t_i[v],  t_i[v] = sum_w J[i][w] Minv[w][v]
  const int nd = 6 + n;
  float w00 = 0.0f, w01 = 0.0f, w11 = 0.0f, w22 = 0.0f;
  float w02 = 0.0f, w12 = 0.0f;
  for (int kv = 0; kv < nd; ++kv) {
    const int dv = kv < 6 ? kv : lo + kv - 6;
    float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;
    for (int kw = 0; kw < nd; ++kw) {
      const int dw = kw < 6 ? kw : lo + kw - 6;
      const float mi = Minv[dw * NV + dv];
      t0 += Jp[kw][0] * mi; t1 += Jp[kw][1] * mi; t2 += Jp[kw][2] * mi;
    }
    w00 += Jp[kv][0] * t0; w01 += Jp[kv][1] * t0;
    w11 += Jp[kv][1] * t1; w22 += Jp[kv][2] * t2;
    if constexpr (!FLAT) {
      w02 += Jp[kv][2] * t0; w12 += Jp[kv][2] * t1;
    }
  }
  W00 = w00 + eps; W01 = w01; W11 = w11 + eps;
  if constexpr (FLAT) {
    inv_wnn = relax / (w22 + eps);
  } else {
    W02 = w02; W12 = w12; W22 = w22 + eps;
    const float Wp[9] = {W00, w01, w02, w01, W11, w12, w02, w12, W22};
    inv_wnn = relax / quad3(Wp, nrm);
  }
}

// One contact point's row update in a projected-Jacobi sweep on flat
// ground (n = +z): the normal row drives v_z to `target` (inv_wnn = relax /
// W22), the friction row pushes against the slip with scalar mass t^T W t
// (floored at 1e-6), and the tangential impulse is clamped to the mu *
// lambda_n cone.  lam: the point's total impulse in; l: the new one (zero
// where the point is not `active`).
__device__ __forceinline__ void flat_row_update(
    const float* v, float W00, float W01, float W11, float target,
    float inv_wnn, float relax, float mu, float active, const float* lam,
    float* l) {
  const float vn = v[2], vtx = v[0], vty = v[1];
  const float vtn = sqrtf(vtx * vtx + vty * vty + 1e-18f);
  const float itn = 1.0f / vtn;
  const float tx = vtx * itn, ty = vty * itn;
  const float w_tt = fmaxf(
      tx * tx * W00 + 2.0f * tx * ty * W01 + ty * ty * W11, 1e-6f);
  const float dln = (target - vn) * inv_wnn;
  const float dlt = -relax * vtn / w_tt;
  const float ln = fmaxf(lam[2] + dln, 0.0f);
  const float lx = lam[0] + dlt * tx;
  const float ly = lam[1] + dlt * ty;
  const float ltn = sqrtf(lx * lx + ly * ly + 1e-18f);
  const float max_t = mu * ln;
  const float scale = ltn > max_t ? max_t / ltn : 1.0f;
  l[0] = lx * scale * active;
  l[1] = ly * scale * active;
  l[2] = ln * active;
}
