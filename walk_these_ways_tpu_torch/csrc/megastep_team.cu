// Whole-control-step kernel for Hopper (sm_90a), one warp per env: one
// launch runs all `decimation` physics substeps of one control step for the
// actuator-network torque model in reuse mode, with the entry cache built
// inside the launch.
//
// Replaces: the JAX package's ops/pallas_megastep.py::_megastep_kernel (the
// TPU kernel reached through control_step_pallas) in reuse mode with the
// actuator network:
//   K4   flat ground (FLAT true, n = +z);
//   K4b  on a heightfield (FLAT false): the height and the surface normal
//        under each contact point are sampled once, at the entry contact
//        points, from the corner-packed heightfield (heightfield_sample,
//        Terrain.lookup's arithmetic), and the normals enter the contact
//        solve through its general-normal rows (normal_row_update).
// The other variants (P control, exact mode) run one thread per env in
// csrc/megastep.cu.
//
// What it computes, per env (envs are independent), as the JAX kernel in
// reuse mode with the cache of the entry state:
//   once:    the dynamics cache of the entry state (the statements of
//            wtw_cache.cuh cache_columns_dev: FK, twist bases, inertia
//            blocks, CRBA, closed-form M^-1, contact points p_cp) about the
//            entry base position; r = p_cp - pos; per point the leg-joint Jacobian
//            columns and W_p = J_p M^-1 J_p^T + eps I (K4b: its six distinct
//            entries and n^T W_p n); K4b: rh = h + radius and n at p_cp;
//   D times: actuator MLP (6 -> H -> H -> 1, softsign, per joint) -> x motor
//            strength -> torque clip -> joint-limit torque -> unconstrained
//            dynamics twice (midpoint rule) -> row-decoupled projected-Jacobi
//            contact solve on the total impulse, the first substep seeded
//            from `lam_in` (or cold with `num_iters` sweeps without it), the
//            later ones warm-started from the previous substep's impulses
//            with `warm_iters` sweeps, gv += M^-1 J^T dlam after each sweep
//            -> contact points advanced at velocity level -> velocity clips
//            -> integrate pos / quaternion exp map / q.
// The iteration counts and the arithmetic are the one-thread kernel's (and
// the plain version's, ops/megastep.control_step_reference fed the eager
// build of the same cache): the same statements in the same order, now
// spread over the lanes of a warp.
//
// Design for this card.  The one-thread kernel ran about one warp per SM at
// 4000 envs and kept ~5 KB of per-env arrays in local memory: it was bound
// by instruction latency at under 1 % of its bound.  Here an env is a team
// of 32 lanes (one warp), TEAM_ENVS envs per block.  The parallel axes are
// the algorithm's own:
//   - the entry cache (team_entry_cache): FK over the joint lanes one tree
//     depth at a time, twist bases over the joint lanes, inertia blocks and
//     contact points over the body and point lanes, the CRBA's sums over
//     the body and joint lanes, the closed-form M^-1's entries over all
//     lanes (its 6 x 6 Schur inverse on lane 0), into shared memory;
//   - actuator network: lane o is hidden unit o of every joint (H = 32);
//     the weights come packed (ops/megastep.team_actuator_weights) so that
//     the warp's loads are 32 consecutive floats, one 128-byte line, read
//     through the read-only path; the output layer is a serial sum by joint
//     j's lane over the 32 units in shared memory;
//   - contact points: lane p (28 of 32) owns point p: its Jacobian columns,
//     W entries, impulse, position, r, normal and gap stay in its registers;
//     it forms its own W_p, runs its own row update in each sweep (the
//     update is row-decoupled) and writes J_p^T dlam_p into shared memory;
//   - sum over points of J_p^T dlam_p: lane d (18 dofs) sums its slot over
//     the points in index order (base dofs over all points, a leg dof over
//     its leg's points), then lane w forms row w of M^-1 x;
//   - dynamics: body twists and bias forces over the 13 body lanes, the
//     velocity-product terms over the 12 joint lanes, tau - bias and
//     M^-1 (tau - bias) over the 18 dof lanes (wtw_device.cuh dyn_core's
//     statements).
// Every sum is serial on one lane in the one-thread kernel's order (and the
// cache build's entries are wtw_cache.cuh's statements), so no env crosses
// a solver branch for another summation order.  Lanes meet only at
// __syncwarp; no shuffles.
//
// Memory.  Per env in shared memory (TeamEnv, 5,696 bytes): M^-1 (324
// floats; M while the cache is built), the twist bases Sw / Sv (108), the
// inertia blocks A / B and the masses (247), the generalized-velocity
// vectors and the base state (109), and one union reused by the phases
// (the cache build's intermediates 636 floats; actuator inputs and hidden
// layers 520; dynamics temporaries 228; the per-point J^T f rows 252).
// TEAM_ENVS = 8 gives 45,568 bytes of static shared memory per 256-thread
// block.  At 4000 envs on 132 SMs one wave needs 31 envs (31 warps) per SM:
// __launch_bounds__ asks ptxas for TEAM_MIN_BLOCKS = 4 resident blocks, 32
// warps, so at most 64 registers a thread (a few spill; ptxas -v, and
// cudaOccupancyMaxActiveBlocksPerMultiprocessor through
// megastep_team_occupancy, report it).  The actuator weights (15,756
// floats, 63 KB, shared by every env) are not staged in shared memory: a
// block holding them would hold 108 KB and two blocks, 16 warps, would fit
// an SM; read as whole lines through the read-only path they stay in L1
// (the SM's 256 KB less the four blocks' 182 KB of shared memory holds
// most of them) and in L2.
//
// Bound on this card (ops/megastep.work_per_env, `entry`): per env 2.5 KB
// (K4b 2.9 KB) in and out and 0.26 MFLOP (K4b 0.29) of fp32 on the CUDA
// cores, the cache build once included, so at 4000 envs the least time is
// set by arithmetic (about 0.016 ms).  No tensor cores: TF32's 10-bit
// mantissa cannot hold the kernel-vs-plain tolerance, and the kernels are
// built without fused multiply-adds (ops/_build.py).  The measured numbers
// are kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_megastep.cuh"
#include "wtw_cache.cuh"

#define TEAM 32          // lanes per env: one warp
#define TEAM_ENVS 8      // envs per block
#define TEAM_MIN_BLOCKS 4  // resident blocks asked of ptxas: 32 warps/SM

// the actuator weights as ops/megastep.team_actuator_weights packs them:
// per joint j the nonzero blocks of the block-diagonal matrices, laid out
// so that lane o (hidden unit o) reads consecutive floats with its
// neighbours: W0[j][f][o], b0[j][o], W1[j][i][o], b1[j][o], W2[o][j], b2[j]
#define NET_W0 0
#define NET_B0 (NET_W0 + NJ * NF * NH)
#define NET_W1 (NET_B0 + NJ * NH)
#define NET_B1 (NET_W1 + NJ * NH * NH)
#define NET_W2 (NET_B1 + NJ * NH)
#define NET_B2 (NET_W2 + NH * NJ)

static_assert(NH == TEAM, "one lane per hidden unit of the actuator network");
static_assert(NJ % 2 == 0, "the actuator network runs two joints at a time");
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
  for (int jj = 0; jj < NJ; ++jj)
    if (lane < NJ && MS_JJ_SUB[lane * NJ + jj]) mk.joint_sub |= 1u << jj;
  return mk;
}

// One env's shared memory.
struct TeamEnv {
  // the entry cache, built once per launch (Minv holds M while it is built)
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

// The dynamics cache of the entry state about the entry base position
// s.ref, into s (sw, sv, A, B, m, Minv) and s.u.build.pcp: wtw_cache.cuh
// cache_columns_dev's statements spread over the lanes — FK one tree depth
// at a time over the joint lanes, the body lanes' inertia blocks, the
// CRBA's sums over the body and joint lanes, the closed-form M^-1's
// entries over all lanes (6 x 6 Schur inverse on lane 0) — each entry
// computed by the same statements in the same order, so the two agree
// bit for bit.  `q`: lane j's joint angle.  Starts after and ends at a
// __syncwarp.
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

// qdd = M^-1 (tau - bias) + centripetal term from the velocity in `gv`, all
// in `s`: wtw_device.cuh dyn_core's statements spread over the lanes (body
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

template <bool FLAT>
__global__ void __launch_bounds__(TEAM * TEAM_ENVS, TEAM_MIN_BLOCKS)
megastep_team_kernel(const MegastepArgs a) {
  __shared__ TeamEnv team_envs[TEAM_ENVS];
  const int lane = threadIdx.x % TEAM;
  TeamEnv& s = team_envs[threadIdx.x / TEAM];
  // the grid covers npad exactly (the launcher checks that TEAM_ENVS
  // divides it): every warp is one env, and all its lanes reach every
  // __syncwarp
  const int env = blockIdx.x * TEAM_ENVS + threadIdx.x / TEAM;
  const size_t npad = (size_t)a.npad;
#define LD(idx, row) __ldg(a.in[idx] + (size_t)(row) * npad + env)
#define ST(idx, row, val) a.out[idx][(size_t)(row) * npad + env] = (val)
#define LDC(idx, k) __ldg(a.in[idx] + (k))

  const float dt = a.f[F_DT], relax = a.f[F_RELAX], eps = a.f[F_EPS];
  const bool is_joint = lane < NJ, is_point = lane < NP;
  const int j = lane, p = lane;
  const int lo = is_point ? MS_PT_LO[p] : 0, n = is_point ? MS_PT_N[p] : 0;
  const LaneMasks mk = lane_masks(lane);

  // ---- entry state: joint lanes own their joint, lanes 0..3 the base ----
  float q = 0.0f, qd = 0.0f, tau_m = 0.0f;
  float el = 0.0f, ell = 0.0f, vl = 0.0f, vll = 0.0f;
  if (is_joint) {
    q = LD(I_Q, j); qd = LD(I_QD, j);
    el = LD(I_EL, j); ell = LD(I_ELL, j);
    vl = LD(I_VL, j); vll = LD(I_VLL, j);
  }
  if (lane < 3) {
    s.pos[lane] = LD(I_POS, lane); s.lin[lane] = LD(I_LIN, lane);
    s.ang[lane] = LD(I_ANG, lane); s.g[lane] = LD(I_G, lane);
    s.ref[lane] = s.pos[lane];
  }
  if (lane < 4) s.quat[lane] = LD(I_QUAT, lane);
  const float mu = LD(I_MU, 0), rest = LD(I_E, 0);
  __syncwarp();

  // ---- the entry cache, about the entry base position ----
  {
    const float comdisp[3] = {LD(I_COMDISP, 0), LD(I_COMDISP, 1),
                              LD(I_COMDISP, 2)};
    team_entry_cache(s, q, LD(I_PAYLOAD, 0), comdisp, mk, lane);
  }

  // ---- the contact points: lane p owns point p ----
  float pcp[3] = {0.0f, 0.0f, 0.0f}, r[3] = {0.0f, 0.0f, 0.0f};
  float lam[3] = {0.0f, 0.0f, 0.0f}, nrm[3] = {0.0f, 0.0f, 1.0f};
  float Jl[GM][3];
  float W00 = 0.0f, W01 = 0.0f, W11 = 0.0f, W02 = 0.0f, W12 = 0.0f;
  float W22 = 0.0f, inv_wnn = 0.0f, rh = 0.0f;
  const bool have_seed = a.in[I_LAM] != nullptr;
  if (is_point) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pcp[i] = s.u.build.pcp[p][i];
      r[i] = pcp[i] - s.pos[i];
      lam[i] = have_seed ? LD(I_LAM, p * 3 + i) : 0.0f;
    }
    rh = LD(I_RH, p);
    if constexpr (!FLAT) {
      // height and normal under the entry contact point: rh = h + radius
      float h;
      heightfield_sample(a.in[I_CORNERS], a.c_rows, a.c_cols, a.f[F_HS],
                         a.f[F_OX], a.f[F_OY], pcp[0], pcp[1], h, nrm);
      rh = h + rh;
    }
    point_cache<FLAT>(p, ThreadRows{s.Minv, 0, 0}, s.sw, s.sv, r, Jl, W00,
                      W01, W11, W02, W12, W22, inv_wnn, nrm, eps, relax);
  }
  __syncwarp();     // the entry contact points are read; the union is free

  // ---- D substeps ----
#pragma unroll 1
  for (int si = 0; si < a.D; ++si) {
    // torque model: the per-joint MLP on [err, el, ell, qd, vl, vll] whose
    // weights are the nonzero blocks of the block-diagonal matrices
    float err = 0.0f;
    if (is_joint) {
      err = q - LD(I_TGT, si * NJ + j);
      const float x[NF] = {err, el, ell, qd, vl, vll};
#pragma unroll
      for (int f = 0; f < NF; ++f) s.u.net.in[j][f] = x[f];
    }
    __syncwarp();
    {
      // hidden unit o of every joint, two joints at a time: two
      // independent sums, each in the one-thread kernel's order
      const int o = lane;
#pragma unroll 1
      for (int jj = 0; jj < NJ; jj += 2) {
        float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          acc0 += LDC(I_NET, NET_W0 + (jj * NF + f) * NH + o)
                * s.u.net.in[jj][f];
          acc1 += LDC(I_NET, NET_W0 + ((jj + 1) * NF + f) * NH + o)
                * s.u.net.in[jj + 1][f];
        }
        float* h0a = s.u.net.h0[jj & 2];
        float* h0b = s.u.net.h0[(jj & 2) + 1];
        h0a[o] = softsign(acc0 + LDC(I_NET, NET_B0 + jj * NH + o));
        h0b[o] = softsign(acc1 + LDC(I_NET, NET_B0 + (jj + 1) * NH + o));
        __syncwarp();
        const float* w1 = a.in[I_NET] + NET_W1 + jj * NH * NH + o;
        acc0 = 0.0f;
        acc1 = 0.0f;
#pragma unroll 8
        for (int i = 0; i < NH; ++i) {
          acc0 += __ldg(w1 + i * NH) * h0a[i];
          acc1 += __ldg(w1 + NH * NH + i * NH) * h0b[i];
        }
        s.u.net.h1[jj][o] = softsign(acc0 + LDC(I_NET, NET_B1 + jj * NH + o));
        s.u.net.h1[jj + 1][o] =
            softsign(acc1 + LDC(I_NET, NET_B1 + (jj + 1) * NH + o));
      }
    }
    __syncwarp();
    if (is_joint) {
      float t = 0.0f;
#pragma unroll 4
      for (int o = 0; o < NH; ++o)
        t += LDC(I_NET, NET_W2 + o * NJ + j) * s.u.net.h1[j][o];
      t += LDC(I_NET, NET_B2 + j);
      ell = el; el = err; vll = vl; vl = qd;
      t = t * LD(I_STR, j);
      t = clampf(t, LDC(I_TLIM, j));
      tau_m = t;
      // joint-limit spring / damper
      const float over = fmaxf(q - LDC(I_QHI, j), 0.0f);
      const float under = fmaxf(LDC(I_QLO, j) - q, 0.0f);
      const float at_lim = (over > 0.0f || under > 0.0f) ? 1.0f : 0.0f;
      const float tau_lim = a.f[F_KLIM] * (under - over)
                          - a.f[F_DLIM] * at_lim * qd;
      s.tau[6 + j] = t + tau_lim;
      s.gv0[6 + j] = qd;
    }
    // unconstrained dynamics at the anchor point, midpoint rule
    float delta[3], cd[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) delta[i] = s.ref[i] - s.pos[i];
    cross3(s.ang, delta, cd);
    if (lane < 3) {
      s.tau[lane] = 0.0f; s.tau[3 + lane] = 0.0f;
      s.gv0[lane] = s.ang[lane];
      s.gv0[3 + lane] = s.lin[lane] + cd[lane];
    }
    __syncwarp();
    team_dynamics(s, s.gv0, mk, lane);
    if (lane < NV) s.gv[lane] = s.gv0[lane] + a.f[F_HALFDT] * s.qdd[lane];
    __syncwarp();
    team_dynamics(s, s.gv, mk, lane);
    if (lane < NV) s.gv[lane] = s.gv0[lane] + dt * s.qdd[lane];  // gv_free
    __syncwarp();

    if (si == a.D - 1 && is_point) {
#pragma unroll
      for (int i = 0; i < 3; ++i) ST(O_PCPPREV, p * 3 + i, pcp[i]);
    }

    if (a.contact) {
      const bool warm = a.warm_iters > 0 && (si > 0 || have_seed);
      const int iters = warm ? a.warm_iters : a.num_iters;
      // gap and velocity target from the free velocity
      float target = 0.0f, active = 0.0f;
      if (is_point) {
        const float phi = rh - pcp[2];
        active = phi > 0.0f ? 1.0f : 0.0f;
        float v0[3];
        point_velocity(s.gv, r, Jl, lo, n, v0);
        float vn0 = v0[2];
        if constexpr (!FLAT)
          vn0 = nrm[0] * v0[0] + nrm[1] * v0[1] + nrm[2] * v0[2];
        const float bounce = vn0 < -a.f[F_BOUNCE] ? -rest * vn0 : 0.0f;
        const float bias = fminf(
            a.f[F_BAUM_DT] * fmaxf(phi - a.f[F_SLOP], 0.0f),
            a.f[F_MAXDEPEN]);
        target = fmaxf(bounce, bias);
      }
      if (warm) {
        // pre-apply the seed impulse: gv = gv0 + M^-1 J^T lam0
        if (is_point) point_jt(lam, r, Jl, n, s.u.jt[p]);
        __syncwarp();
        team_apply_impulses(s, lane);
      } else {
        lam[0] = lam[1] = lam[2] = 0.0f;
      }
#pragma unroll 1
      for (int it = 0; it < iters; ++it) {
        if (is_point) {
          float v[3], l[3];
          point_velocity(s.gv, r, Jl, lo, n, v);
          if constexpr (FLAT) {
            flat_row_update(v, W00, W01, W11, target, inv_wnn, relax, mu,
                            active, lam, l);
          } else {
            const float Wp[9] = {W00, W01, W02, W01, W11, W12,
                                 W02, W12, W22};
            l[0] = lam[0]; l[1] = lam[1]; l[2] = lam[2];
            normal_row_update(v, nrm, Wp, target, inv_wnn, relax, mu,
                              active, l);
          }
          const float dl[3] = {l[0] - lam[0], l[1] - lam[1], l[2] - lam[2]};
          lam[0] = l[0]; lam[1] = l[1]; lam[2] = l[2];
          point_jt(dl, r, Jl, n, s.u.jt[p]);
        }
        __syncwarp();
        team_apply_impulses(s, lane);
      }
      // advance the points with the clamped velocities
      if (lane < NV) s.x[lane] = clampf(s.gv[lane], LDC(I_VLIM, lane));
      __syncwarp();
      if (is_point) {
        float v[3];
        point_velocity(s.x, r, Jl, lo, n, v);
        pcp[0] += dt * v[0]; pcp[1] += dt * v[1]; pcp[2] += dt * v[2];
      }
    } else {
      lam[0] = lam[1] = lam[2] = 0.0f;
    }

    // clips + integration
    if (is_joint) {
      qd = clampf(s.gv[6 + j], LDC(I_VLIM, 6 + j));
      q = q + dt * qd;
    }
    if (lane == 0) {
      float ang[3], vref[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        ang[i] = clampf(s.gv[i], a.f[F_MAXANG]);
        vref[i] = clampf(s.gv[3 + i], a.f[F_MAXLIN]);
      }
      cross3(ang, delta, cd);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s.ang[i] = ang[i];
        s.lin[i] = vref[i] - cd[i];
        s.pos[i] = s.pos[i] + dt * s.lin[i];
      }
      // quaternion exp map, xyzw, world angular velocity
      const float angle = sqrtf(ang[0] * ang[0] + ang[1] * ang[1]
                                + ang[2] * ang[2]);
      const float ia = fmaxf(angle, 1e-9f);
      float ax[3] = {ang[0] / ia, ang[1] / ia, ang[2] / ia};
      const float an = fmaxf(
          sqrtf(ax[0] * ax[0] + ax[1] * ax[1] + ax[2] * ax[2]), 1e-9f);
      ax[0] = ax[0] / an; ax[1] = ax[1] / an; ax[2] = ax[2] / an;
      const float half = 0.5f * (angle * dt);
      const float sn = sinf(half);
      const float dx = ax[0] * sn, dy = ax[1] * sn, dz = ax[2] * sn;
      const float dw = cosf(half);
      const float qx = s.quat[0], qy = s.quat[1], qz = s.quat[2],
                  qw = s.quat[3];
      const float rx = dw * qx + dx * qw + dy * qz - dz * qy;
      const float ry = dw * qy - dx * qz + dy * qw + dz * qx;
      const float rz = dw * qz + dx * qy - dy * qx + dz * qw;
      const float rw = dw * qw - dx * qx - dy * qy - dz * qz;
      const float inv = 1.0f / fmaxf(
          sqrtf(rx * rx + ry * ry + rz * rz + rw * rw), 1e-9f);
      s.quat[0] = rx * inv; s.quat[1] = ry * inv;
      s.quat[2] = rz * inv; s.quat[3] = rw * inv;
    }
    __syncwarp();
  }

  // ---- exit state ----
  if (is_joint) {
    ST(O_Q, j, q); ST(O_QD, j, qd); ST(O_TAU, j, tau_m);
    ST(O_EL, j, el); ST(O_ELL, j, ell); ST(O_VL, j, vl); ST(O_VLL, j, vll);
  }
  if (lane < 3) {
    ST(O_POS, lane, s.pos[lane]); ST(O_LIN, lane, s.lin[lane]);
    ST(O_ANG, lane, s.ang[lane]);
  }
  if (lane < 4) ST(O_QUAT, lane, s.quat[lane]);
  if (is_point) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ST(O_PCP, p * 3 + i, pcp[i]);
      ST(O_LAM, p * 3 + i, lam[i]);
    }
  }
#undef LD
#undef ST
#undef LDC
}

// Plain C interface for ctypes, the arguments of csrc/megastep.cu's
// megastep_launch (wtw_megastep.cuh).  Takes the actuator network in reuse
// mode with the entry cache built here: in[I_PAYLOAD], in[I_COMDISP] in
// place of the cache (Sw .. p_cp null), on a heightfield (flat 0) the
// corner-packed field in[I_CORNERS] of ip[P_CROWS] x ip[P_CCOLS] cells and
// its pitch and origin f[F_HS], f[F_OX], f[F_OY] in place of the normals
// (in[I_N] null).  `threads` must be TEAM * TEAM_ENVS and npad a multiple
// of TEAM_ENVS.  Launches on `stream`, does not synchronise, returns the
// launch's cudaError_t (0 = launched).
extern "C" int megastep_team_launch(const void* const* in, void* const* out,
                                    const float* f, const int* ip,
                                    void* stream) {
  const MegastepArgs a = megastep_args(in, out, f, ip);
  const int threads = ip[P_THREADS], flat = ip[P_FLAT];
  if (threads != TEAM * TEAM_ENVS || a.npad < 1 || a.npad % TEAM_ENVS
      || a.D < 1 || ip[P_PCTRL] || ip[P_EXACT] || !ip[P_ENTRY]
      || a.in[I_N] != nullptr || a.in[I_PAYLOAD] == nullptr
      || (!flat && (a.in[I_CORNERS] == nullptr || a.c_rows < 1
                    || a.c_cols < 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = a.npad / TEAM_ENVS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (flat)
    megastep_team_kernel<true><<<blocks, threads, 0, st>>>(a);
  else
    megastep_team_kernel<false><<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* megastep_team_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int megastep_team_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}

// Resident blocks of the team kernel per SM (flat, heightfield), and its
// threads and static shared memory per block; returns the cudaError_t.
extern "C" int megastep_team_occupancy(int* blocks_flat, int* blocks_rough,
                                       int* threads, int* smem_bytes) {
  *threads = TEAM * TEAM_ENVS;
  *smem_bytes = (int)(sizeof(TeamEnv) * TEAM_ENVS);
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_flat, megastep_team_kernel<true>, *threads, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_rough, megastep_team_kernel<false>, *threads, 0);
  return (int)e;
}
