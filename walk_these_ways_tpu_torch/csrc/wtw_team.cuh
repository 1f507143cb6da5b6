// What the warp-per-env kernels share: one env is a team of 32 lanes (one
// warp), TEAM_ENVS envs per block, and the env's data in shared memory
// (TeamEnv).  Included by csrc/megastep_team.cu (the control-step kernel:
// K4, K4b, K4c, K4b-P, K5, K5-P), csrc/dynamics_substep.cu (the
// dynamics-substep kernel: K3, K3b) and csrc/entry_cache.cu (the
// per-substep route's entry cache).  The contact-substep kernel
// (csrc/contact_substep.cu, K2) runs one warp per env too, but it is given
// no robot topology, which this header needs: it keeps its own dense
// counterpart of team_apply_impulses.
//
//   lane_masks           the robot's ancestor tables as one lane's bit masks;
//   TeamEnv              one env's shared memory: the dynamics cache (twist
//                        bases, inertia blocks, masses, M^-1), the base
//                        state, the generalized-velocity vectors and one
//                        union reused by the phases;
//   team_entry_cache     the dynamics cache of a state, physics/envminor
//                        cache_columns' statements spread over the lanes
//                        (needs the model tables, MS_HAVE_MODEL);
//   team_dynamics        ops/dynamics.dyn_core's statements spread over
//                        the lanes;
//   team_apply_impulses  gv += M^-1 sum_p J_p^T f_p from the points' rows;
//   point_jt             one point's row of J^T f from r and its leg columns.
//
// Every sum is serial on one lane in the plain version's order, so a team
// kernel and the plain version it is held to take the same solver
// branches.
// Include after the generated "wtw_topology.h".
#pragma once
#include "wtw_device.cuh"
#include "wtw_cache.cuh"

#define TEAM 32          // lanes per env: one warp
#define TEAM_ENVS 8      // envs per block
#define TEAM_MIN_BLOCKS 4  // resident blocks asked of ptxas: 32 warps/SM

static_assert(NV <= 32 && NB <= 32, "bit masks over dofs and bodies");
static_assert(NP <= TEAM && NV <= TEAM && NB <= TEAM && NJ <= TEAM,
              "one lane per contact point, dof, body and joint");

// The robot's ancestor tables as one lane's bit masks, read once: the
// __constant__ tables indexed by the lane would be read at up to 32
// addresses at a time, one after another.
struct LaneMasks {
  unsigned dof_bodies;    // dof lane w: the bodies b with MS_ANC[w][b]
  unsigned body_dofs;     // body lane b: the dofs d with MS_ANC[d][b]
  unsigned joint_bodies;  // joint lane j: the bodies b with MS_ANC[6 + j][b]
  unsigned joint_sub;     // joint lane j: the joints jj with MS_JJ_SUB[j][jj]
};

__device__ __forceinline__ LaneMasks lane_masks(int lane) {
  LaneMasks mk{0u, 0u, 0u, 0u};
  for (int b = 0; b < NB; ++b) {
    if (lane < NV && MS_ANC[lane * NB + b]) mk.dof_bodies |= 1u << b;
    if (lane < NJ && MS_ANC[(6 + lane) * NB + b]) mk.joint_bodies |= 1u << b;
  }
  for (int d = 0; d < NV; ++d)
    if (lane < NB && MS_ANC[d * NB + lane]) mk.body_dofs |= 1u << d;
#ifdef MS_HAVE_MODEL             // joint_sub: the entry-cache build's
  for (int jj = 0; jj < NJ; ++jj)
    if (lane < NJ && MS_JJ_SUB[lane * NJ + jj]) mk.joint_sub |= 1u << jj;
#endif
  return mk;
}

// One env's shared memory.
struct TeamEnv {
  // the dynamics cache (Minv holds M while it is built)
  float sw[NV][3], sv[NV][3];
  float A[NB * 9], B[NB * 9], m[NB];
  float Minv[NV * NV];
  // the base state (the joints' lanes own q, qd and the histories)
  float pos[3], lin[3], ang[3], quat[4], g[3], ref[3];
  // generalized-velocity vectors: the substep's start, the current one, the
  // accelerations, the torques, and x (tau - bias, or the sum of J^T f)
  float gv0[NV], gv[NV], qdd[NV], tau[NV], x[NV];
  union {
    struct {                    // the entry-cache build's intermediates
      float R[NB][9], p[NB][3], axw[NJ][3], anw[NJ][3];
      float ca[NJ][3], cb[NJ][3];
      float Dinv[NJ / 3][9], BD[6][NJ], S[36], Sinv[36], T[6][NJ];
      float pcp[NP][3];         // the entry contact points
    } build;
    struct {
      float in[NJ][NF];         // per joint: err, el, ell, qd, vl, vll
      float h0[4][NH];          // layer 0 of two joints (double-buffered)
      float h1[NJ][NH];         // layer 1 of every joint
    } net;
    struct {
      float Vw[NB][3], Vv[NB][3], Cw[NJ][3], Cv[NJ][3];
      float Fw[NB][3], Fv[NB][3];
    } dyn;
    float jt[NP][6 + GM];       // per point: J_p^T f over its dofs
  } u;
};

#ifdef MS_HAVE_MODEL
// The dynamics cache of the state (s.quat, `q`) about the base position
// s.ref, into s (sw, sv, A, B, m, Minv) and s.u.build.pcp: physics/envminor
// cache_columns' statements spread over the lanes — FK one tree depth
// at a time over the joint lanes, the body lanes' inertia blocks, the
// CRBA's sums over the body and joint lanes, the closed-form M^-1's
// entries over all lanes (6 x 6 Schur inverse on lane 0) — each entry
// computed by the same statements in the same order, so the two differ
// by the float32 sinf and cosf only.  `q`: lane j's joint angle.  Starts
// after and ends at a __syncwarp.
__device__ __forceinline__ void team_entry_cache(TeamEnv& s, float q,
                                                 float payload,
                                                 const float* comdisp,
                                                 const LaneMasks& mk,
                                                 int lane) {
  auto& c = s.u.build;
  float* M = s.Minv;              // M, then M^-1 in its place
  const float* ref = s.ref;
  if (lane == 0) {                // base pose
    const float qx = s.quat[0], qy = s.quat[1], qz = s.quat[2],
                qw = s.quat[3];
    const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
    const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
    const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
    float* R = c.R[0];
    R[0] = 1 - 2 * (yy + zz); R[1] = 2 * (xy - wz); R[2] = 2 * (xz + wy);
    R[3] = 2 * (xy + wz); R[4] = 1 - 2 * (xx + zz); R[5] = 2 * (yz - wx);
    R[6] = 2 * (xz - wy); R[7] = 2 * (yz + wx); R[8] = 1 - 2 * (xx + yy);
#pragma unroll
    for (int i = 0; i < 3; ++i) c.p[0][i] = ref[i];
  }
  for (int k = lane; k < NV * NV; k += TEAM) M[k] = 0.0f;
  __syncwarp();

  // ---- FK: the joints of one depth at a time, parent before child ----
  const int j = lane;
#pragma unroll 1
  for (int level = 1; level <= MS_FK_DEPTHS; ++level) {
    if (j < NJ && MS_JOINT_DEPTH[j] == level) {
      const int b = MS_JOINT_BODY[j], pb = MS_PARENT[b];
      const float sn = sinf(q), c1 = 1.0f - cosf(q);
      float rot[9], an[3], ax[3], t[3];
#pragma unroll
      for (int e = 0; e < 9; ++e)
        rot[e] = ((e % 4 == 0 ? 1.0f : 0.0f) + MS_JOINT_K[9 * j + e] * sn)
               + MS_JOINT_KK[9 * j + e] * c1;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        an[i] = MS_JOINT_ANCHOR[3 * j + i];
        ax[i] = MS_JOINT_AXIS[3 * j + i];
      }
      m3v(c.R[pb], an, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) c.anw[j][i] = c.p[pb][i] + t[i];
      m3v(c.R[pb], ax, c.axw[j]);
      m3mul(c.R[pb], rot, c.R[b]);
#pragma unroll
      for (int i = 0; i < 3; ++i) c.p[b][i] = c.anw[j][i];
    }
    __syncwarp();
  }

  // ---- twist bases, inertia blocks about ref, contact points ----
  if (lane < 6) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.sw[lane][i] = (lane == i) ? 1.0f : 0.0f;
      s.sv[lane][i] = (lane == 3 + i) ? 1.0f : 0.0f;
    }
  }
  if (j < NJ) {
    float dr[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.sw[6 + j][i] = c.axw[j][i];
      dr[i] = c.anw[j][i] - ref[i];
    }
    cross3(dr, c.axw[j], s.sv[6 + j]);
  }
  if (lane < NB) {
    const int b = lane;
    const float* R = c.R[b];
    float mb = MS_MASS[b];
    if (b == 0) mb = mb + payload;
    float cl[3] = {MS_COM[3 * b], MS_COM[3 * b + 1], MS_COM[3 * b + 2]};
    float t[3], com[3];
    m3v(R, cl, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) com[i] = c.p[b][i] + t[i];
    if (b == 0) {
      m3v(R, comdisp, t);
#pragma unroll
      for (int i = 0; i < 3; ++i) com[i] = com[i] + t[i];
    }
    // the base's rotational inertia scales with its mass, payload included
    const float scale0 = (MS_MASS[0] + payload) / MS_MASS[0];
    float Il[9], tt[9], Iw[9], rx[9], mrx[9], mrxrx[9];
#pragma unroll
    for (int k = 0; k < 9; ++k)
      Il[k] = b == 0 ? MS_INERTIA[9 * b + k] * scale0 : MS_INERTIA[9 * b + k];
    m3mul_bt(Il, R, tt);              // I_l R^T
    m3mul(R, tt, Iw);                 // R (I_l R^T)
    const float r0 = com[0] - ref[0], r1 = com[1] - ref[1],
                r2 = com[2] - ref[2];
    rx[0] = 0.0f; rx[1] = -r2;  rx[2] = r1;
    rx[3] = r2;   rx[4] = 0.0f; rx[5] = -r0;
    rx[6] = -r1;  rx[7] = r0;   rx[8] = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) mrx[k] = mb * rx[k];
    m3mul(mrx, rx, mrxrx);
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      s.A[9 * b + k] = Iw[k] - mrxrx[k];
      s.B[9 * b + k] = mrx[k];
    }
    s.m[b] = mb;
  }
  if (lane < NP) {
    const int b = MS_CP_BODY[lane];
    float off[3] = {MS_CP_OFFSET[3 * lane], MS_CP_OFFSET[3 * lane + 1],
                    MS_CP_OFFSET[3 * lane + 2]}, t[3];
    m3v(c.R[b], off, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) c.pcp[lane][i] = c.p[b][i] + t[i];
  }
  __syncwarp();

  // ---- CRBA over the static sparsity: M, then +1e-7 on its diagonal ----
  if (lane < 9) {                 // base totals: A, B, m over the bodies
    float acc = s.A[lane];
    for (int b = 1; b < NB; ++b) acc += s.A[9 * b + lane];
    M[(lane / 3) * NV + lane % 3] = acc;
  } else if (lane < 18) {
    const int k = lane - 9, i = k / 3, jj = k % 3;
    float acc = s.B[k];
    for (int b = 1; b < NB; ++b) acc += s.B[9 * b + k];
    M[i * NV + 3 + jj] = acc;
    M[(3 + jj) * NV + i] = acc;
  } else if (lane == 18) {
    float mt = s.m[0];
    for (int b = 1; b < NB; ++b) mt = mt + s.m[b];
#pragma unroll
    for (int i = 0; i < 3; ++i) M[(3 + i) * NV + 3 + i] = mt;
  }
  if (j < NJ) {                   // composite-inertia columns
    float Ac[9], Bc[9], mc = 0.0f;
    bool first = true;
    for (int b = 0; b < NB; ++b) {
      if (!((mk.joint_bodies >> b) & 1u)) continue;
      if (first) {
#pragma unroll
        for (int k = 0; k < 9; ++k) { Ac[k] = s.A[9 * b + k]; Bc[k] = s.B[9 * b + k]; }
        mc = s.m[b];
        first = false;
      } else {
#pragma unroll
        for (int k = 0; k < 9; ++k) { Ac[k] += s.A[9 * b + k]; Bc[k] += s.B[9 * b + k]; }
        mc = mc + s.m[b];
      }
    }
    float t1[3], t2[3];
    m3v(Ac, s.sw[6 + j], t1);
    m3v(Bc, s.sv[6 + j], t2);
#pragma unroll
    for (int i = 0; i < 3; ++i) c.ca[j][i] = t1[i] + t2[i];
    m3tv(Bc, s.sw[6 + j], t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      c.cb[j][i] = t1[i] + mc * s.sv[6 + j][i];
      M[i * NV + 6 + j] = c.ca[j][i];
      M[(6 + j) * NV + i] = c.ca[j][i];
      M[(3 + i) * NV + 6 + j] = c.cb[j][i];
      M[(6 + j) * NV + 3 + i] = c.cb[j][i];
    }
  }
  __syncwarp();
  if (j < NJ) {                   // joint-joint entries, row j
    for (int jj = 0; jj < NJ; ++jj) {
      // nonzero iff dof j is an ancestor of (or equals) dof jj
      if (!((mk.joint_sub >> jj) & 1u)) continue;
      const float val = (s.sw[6 + j][0] * c.ca[jj][0]
                         + s.sw[6 + j][1] * c.ca[jj][1]
                         + s.sw[6 + j][2] * c.ca[jj][2])
                      + (s.sv[6 + j][0] * c.cb[jj][0]
                         + s.sv[6 + j][1] * c.cb[jj][1]
                         + s.sv[6 + j][2] * c.cb[jj][2]);
      M[(6 + j) * NV + 6 + jj] = val;
      M[(6 + jj) * NV + 6 + j] = val;
    }
  }
  __syncwarp();
  if (lane < NV) M[lane * NV + lane] += 1e-7f;
  __syncwarp();

  // ---- closed-form M^-1: per-leg 3x3 blocks D, 6x6 Schur complement ----
  const float eps = 1e-8f;
  if (lane < NJ / 3) {
    const int o = 6 + 3 * lane;
    float Dc[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) Dc[3 * i + jj] = M[(o + i) * NV + o + jj];
    inv3_eps(Dc, eps, c.Dinv[lane]);
  }
  __syncwarp();
  for (int e = lane; e < 6 * NJ; e += TEAM) {
    const int i = e / NJ, col = e % NJ, leg = col / 3, jj = col % 3;
    const float* Bi = M + i * NV + 6 + 3 * leg;     // B6[i][3 leg + k]
    c.BD[i][col] = Bi[0] * c.Dinv[leg][jj] + Bi[1] * c.Dinv[leg][3 + jj]
                 + Bi[2] * c.Dinv[leg][6 + jj];
  }
  __syncwarp();
  for (int e = lane; e < 36; e += TEAM) {
    const int i = e / 6, jj = e % 6;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NJ; ++k) acc += c.BD[i][k] * M[jj * NV + 6 + k];
    c.S[e] = M[i * NV + jj] - acc;
  }
  __syncwarp();
  if (lane == 0) inv_spd6(c.S, eps, c.Sinv);
  __syncwarp();
  for (int e = lane; e < 6 * NJ; e += TEAM) {
    const int i = e / NJ, jj = e % NJ;
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) acc += c.Sinv[6 * i + k] * c.BD[k][jj];
    c.T[i][jj] = acc;
  }
  __syncwarp();
  // every entry of M^-1 from Sinv, T, BD and Dinv: M is read no more
  for (int e = lane; e < NV * NV; e += TEAM) {
    const int row = e / NV, col = e % NV;
    float val;
    if (row < 6 && col < 6) {
      val = c.Sinv[6 * row + col];
    } else if (row < 6) {
      val = -c.T[row][col - 6];
    } else if (col < 6) {
      val = -c.T[col][row - 6];
    } else {
      const int i = row - 6, jj = col - 6;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += c.BD[k][i] * c.T[k][jj];
      const float d = (i / 3 == jj / 3) ? c.Dinv[i / 3][3 * (i % 3) + jj % 3]
                                        : 0.0f;
      val = d + acc;
    }
    M[e] = val;
  }
  __syncwarp();
}
#endif  // MS_HAVE_MODEL

// qdd = M^-1 (tau - bias) + centripetal term from the velocity in `gv`, all
// in `s`: ops/dynamics.dyn_core's statements spread over the lanes (body
// lanes, joint lanes, dof lanes), every sum serial in dyn_core's order.
// Starts and ends at a __syncwarp.
__device__ __forceinline__ void team_dynamics(TeamEnv& s, const float* gv,
                                              const LaneMasks& mk,
                                              int lane) {
  if (lane < NB) {                       // body twists
    const int b = lane;
    float w[3] = {0.0f, 0.0f, 0.0f}, v[3] = {0.0f, 0.0f, 0.0f};
    for (int d = 0; d < NV; ++d) {
      if ((mk.body_dofs >> d) & 1u) {
        const float sd = gv[d];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          w[i] += s.sw[d][i] * sd;
          v[i] += s.sv[d][i] * sd;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.u.dyn.Vw[b][i] = w[i];
      s.u.dyn.Vv[b][i] = v[i];
    }
  }
  __syncwarp();
  if (lane < NJ) {                       // velocity-product terms
    const int j = lane, jb = MS_JOINT_BODY[j];
    const float qd = gv[6 + j];
    float c1[3], c2[3], c3[3];
    cross3(s.u.dyn.Vw[jb], s.sw[6 + j], c1);
    cross3(s.u.dyn.Vw[jb], s.sv[6 + j], c2);
    cross3(s.u.dyn.Vv[jb], s.sw[6 + j], c3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.u.dyn.Cw[j][i] = c1[i] * qd;
      s.u.dyn.Cv[j][i] = (c2[i] + c3[i]) * qd;
    }
  }
  __syncwarp();
  if (lane < NB) {                       // F = I a + V x* (I V) per body
    const int b = lane;
    float aw[3] = {0.0f, 0.0f, 0.0f};
    float av[3] = {-s.g[0], -s.g[1], -s.g[2]};
    for (int j = 0; j < NJ; ++j) {
      if ((mk.body_dofs >> (6 + j)) & 1u) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          aw[i] += s.u.dyn.Cw[j][i];
          av[i] += s.u.dyn.Cv[j][i];
        }
      }
    }
    const float* A9 = s.A + b * 9;
    const float* B9 = s.B + b * 9;
    const float mb = s.m[b];
    const float* Vw = s.u.dyn.Vw[b];
    const float* Vv = s.u.dyn.Vv[b];
    float t1[3], t2[3], IVw[3], IVv[3], IAw[3], IAv[3];
    m3v(A9, Vw, t1); m3v(B9, Vv, t2);
#pragma unroll
    for (int i = 0; i < 3; ++i) IVw[i] = t1[i] + t2[i];
    m3tv(B9, Vw, t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) IVv[i] = t1[i] + mb * Vv[i];
    m3v(A9, aw, t1); m3v(B9, av, t2);
#pragma unroll
    for (int i = 0; i < 3; ++i) IAw[i] = t1[i] + t2[i];
    m3tv(B9, aw, t1);
#pragma unroll
    for (int i = 0; i < 3; ++i) IAv[i] = t1[i] + mb * av[i];
    float x1[3], x2[3], x3[3];
    cross3(Vw, IVw, x1); cross3(Vv, IVv, x2); cross3(Vw, IVv, x3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      s.u.dyn.Fw[b][i] = IAw[i] + x1[i] + x2[i];
      s.u.dyn.Fv[b][i] = IAv[i] + x3[i];
    }
  }
  __syncwarp();
  if (lane < NV) {                       // x = tau - bias
    float acc = 0.0f;
    if (lane < 6) {
      // root rows of the twist basis are unit vectors
      const int i = lane % 3;
      for (int b = 0; b < NB; ++b)
        acc += lane < 3 ? s.u.dyn.Fw[b][i] : s.u.dyn.Fv[b][i];
    } else {
      const int j = lane - 6;
      for (int b = 0; b < NB; ++b) {
        if ((mk.dof_bodies >> b) & 1u) {
          const float* Fw = s.u.dyn.Fw[b];
          const float* Fv = s.u.dyn.Fv[b];
          acc += s.sw[6 + j][0] * Fw[0] + s.sw[6 + j][1] * Fw[1]
               + s.sw[6 + j][2] * Fw[2]
               + s.sv[6 + j][0] * Fv[0] + s.sv[6 + j][1] * Fv[1]
               + s.sv[6 + j][2] * Fv[2];
        }
      }
    }
    s.x[lane] = s.tau[lane] - acc;
  }
  __syncwarp();
  if (lane < NV) {                       // qdd = M^-1 x + centripetal term
    const int w = lane;
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) acc += s.Minv[w * NV + v] * s.x[v];
    if (w >= 3 && w < 6) {
      float corr[3];
      cross3(gv, gv + 3, corr);
      acc += corr[w - 3];
    }
    s.qdd[w] = acc;
  }
  __syncwarp();
}

// gv += M^-1 sum_p J_p^T f_p, from the rows s.u.jt the point lanes wrote:
// lane d sums dof d over the points in index order, then lane w forms row w
// of M^-1 x.  Starts after and ends at a __syncwarp.
__device__ __forceinline__ void team_apply_impulses(TeamEnv& s, int lane) {
  if (lane < NV) {
    const int d = lane;
    float acc = 0.0f;
    for (int p = 0; p < NP; ++p) {
      if (d < 6) {
        acc += s.u.jt[p][d];
      } else {
        const int k = d - MS_PT_LO[p];
        if (k >= 0 && k < MS_PT_N[p]) acc += s.u.jt[p][6 + k];
      }
    }
    s.x[d] = acc;
  }
  __syncwarp();
  if (lane < NV) {
    const int w = lane;
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) acc += s.Minv[w * NV + v] * s.x[v];
    s.gv[w] += acc;
  }
  __syncwarp();
}

// Point p's row of J^T f: (r x f, f, its leg columns . f).
__device__ __forceinline__ void point_jt(const float* f, const float* r,
                                         const float (*Jl)[3], int n,
                                         float* row) {
  float c[3];
  cross3(r, f, c);
  row[0] = c[0]; row[1] = c[1]; row[2] = c[2];
  row[3] = f[0]; row[4] = f[1]; row[5] = f[2];
  for (int k = 0; k < n; ++k)
    row[6 + k] = Jl[k][0] * f[0] + Jl[k][1] * f[1] + Jl[k][2] * f[2];
}
