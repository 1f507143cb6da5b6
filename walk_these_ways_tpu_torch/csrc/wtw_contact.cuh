// Contact solve of one env on a dense point Jacobian kept in global memory:
// gaps and velocity targets, `num_iters` row-decoupled projected-Jacobi
// sweeps on the total impulse (cold start, the friction cone saturating
// exactly), impulses applied lazily as gv += M^-1 J^T dlam, then the contact
// points advanced with the clamped velocities.  Flat ground (n = +z) or, with
// NORMALS, a per-point surface normal read from global memory: the normal
// row's mass n^T W n and the general-normal rows of wtw_device.cuh's
// normal_row_update, on all nine entries of the point's W.
//
// Shared by csrc/contact_substep.cu (the whole kernel, flat only) and
// csrc/dynamics_substep.cu (its second half).  Include after
// "wtw_topology.h" and "wtw_device.cuh".  The arithmetic is the JAX package's
// ops/pallas_contact.py::contact_core with lam0=None and n=None (flat) or the
// normals given.
//
// J is read, never copied: each sweep walks it once, one point's 3 x nd
// entries at a time, and uses those entries for both J_p gv and J_p^T dlam.
// With SPARSE (the generated header carries the point->dof ranges
// MS_PT_LO / MS_PT_N) a point touches the six base dofs and its own leg's
// range only; the entries outside are exact zeros and are not read.
// Without it every point is taken over all NV dofs.
#pragma once

struct ContactParams {
  float dt, relax, baum_dt, slop, max_depen, bounce;
  int num_iters;
};

// J_p (3 x nd entries of point p) -> local rows; returns nd.  Local column k
// stands for dof k (k < 6) or dof lo + k - 6.
template <bool SPARSE>
__device__ __forceinline__ int load_jp(const float* __restrict__ J, int p,
                                       float (*Jp)[NV], int* lo_out,
                                       size_t npad, int env) {
  int lo = 6, n = NV - 6;
#ifdef MS_NB
  if (SPARSE) { lo = MS_PT_LO[p]; n = MS_PT_N[p]; }
#endif
  const int nd = 6 + n;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* row = J + ((size_t)(p * 3 + i) * NV) * npad + env;
    for (int k = 0; k < nd; ++k) {
      const int d = k < 6 ? k : lo + k - 6;
      Jp[i][k] = __ldg(row + (size_t)d * npad);
    }
  }
  *lo_out = lo;
  return nd;
}

// v = J_p x over the point's dofs
__device__ __forceinline__ void jp_dot(const float (*Jp)[NV], int nd, int lo,
                                       const float* x, float* v) {
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  for (int k = 0; k < nd; ++k) {
    const float s = x[k < 6 ? k : lo + k - 6];
    v0 += Jp[0][k] * s; v1 += Jp[1][k] * s; v2 += Jp[2][k] * s;
  }
  v[0] = v0; v[1] = v1; v[2] = v2;
}

// The nine entries of point p's W (env-minor (NP, 9, npad)), row-major
__device__ __forceinline__ void load_w9(const float* __restrict__ W, int p,
                                        size_t npad, int env, float* out) {
  const float* Wp = W + (size_t)(p * 9) * npad + env;
#pragma unroll
  for (int k = 0; k < 9; ++k) out[k] = __ldg(Wp + k * npad);
}

// gv: in the free velocity, out the post-contact velocity (NV).  pcp_in /
// pcp_out / lam_out: env-minor (NP, 3, npad) in global memory.  rh (NP, npad),
// vlim (NV) shared by all envs; nrm (NP, 3, npad) the surface normals with
// NORMALS, else unread.
template <bool SPARSE, bool NORMALS>
__device__ __noinline__ void contact_core_dev(
    const float* __restrict__ J, const float* __restrict__ W,
    const float* __restrict__ Minv, const float* __restrict__ pcp_in,
    const float* __restrict__ rh, const float* __restrict__ vlim,
    const float* __restrict__ nrm, float mu, float rest,
    const ContactParams c, float* gv, float* __restrict__ pcp_out,
    float* __restrict__ lam_out, size_t npad, int env) {
  float lam[NP][3], target[NP], active[NP];
  float W00[NP], W01[NP], W11[NP], inv_wnn[NP];
  float Jp[3][NV];

  // gaps and velocity targets from the free velocity
#pragma unroll 1
  for (int p = 0; p < NP; ++p) {
    const float pz = __ldg(pcp_in + (size_t)(p * 3 + 2) * npad + env);
    const float phi = __ldg(rh + (size_t)p * npad + env) - pz;
    active[p] = phi > 0.0f ? 1.0f : 0.0f;
    int lo;
    const int nd = load_jp<SPARSE>(J, p, Jp, &lo, npad, env);
    float v0[3];
    jp_dot(Jp, nd, lo, gv, v0);
    float vn0 = v0[2], n[3];
    if constexpr (NORMALS) {
      load_normal(nrm, p, npad, env, n);
      vn0 = n[0] * v0[0] + n[1] * v0[1] + n[2] * v0[2];
    }
    const float bounce = vn0 < -c.bounce ? -rest * vn0 : 0.0f;
    const float bias = fminf(c.baum_dt * fmaxf(phi - c.slop, 0.0f),
                             c.max_depen);
    target[p] = fmaxf(bounce, bias);
    if constexpr (NORMALS) {
      float W9[9];
      load_w9(W, p, npad, env, W9);
      inv_wnn[p] = c.relax / quad3(W9, n);
    } else {
      const float* Wp = W + (size_t)(p * 9) * npad + env;
      W00[p] = __ldg(Wp);
      W01[p] = __ldg(Wp + npad);
      W11[p] = __ldg(Wp + 4 * npad);
      inv_wnn[p] = c.relax / __ldg(Wp + 8 * npad);
    }
    lam[p][0] = lam[p][1] = lam[p][2] = 0.0f;
  }

  float jta[NV], dgv[NV];
#pragma unroll 1
  for (int it = 0; it < c.num_iters; ++it) {
#pragma unroll
    for (int v = 0; v < NV; ++v) jta[v] = 0.0f;
#pragma unroll 1
    for (int p = 0; p < NP; ++p) {
      int lo;
      const int nd = load_jp<SPARSE>(J, p, Jp, &lo, npad, env);
      float v[3];
      jp_dot(Jp, nd, lo, gv, v);
      float l[3] = {lam[p][0], lam[p][1], lam[p][2]};
      if constexpr (NORMALS) {
        float W9[9], n[3];
        load_w9(W, p, npad, env, W9);
        load_normal(nrm, p, npad, env, n);
        normal_row_update(v, n, W9, target[p], inv_wnn[p], c.relax, mu,
                          active[p], l);
      } else {
        const float vn = v[2], vtx = v[0], vty = v[1];
        const float vtn = sqrtf(vtx * vtx + vty * vty + 1e-18f);
        const float itn = 1.0f / vtn;
        const float tx = vtx * itn, ty = vty * itn;
        const float w_tt = fmaxf(
            tx * tx * W00[p] + 2.0f * tx * ty * W01[p] + ty * ty * W11[p],
            1e-6f);
        const float dln = (target[p] - vn) * inv_wnn[p];
        const float dlt = -c.relax * vtn / w_tt;
        const float ln = fmaxf(lam[p][2] + dln, 0.0f);
        float lx = lam[p][0] + dlt * tx;
        float ly = lam[p][1] + dlt * ty;
        const float ltn = sqrtf(lx * lx + ly * ly + 1e-18f);
        const float max_t = mu * ln;
        const float scale = ltn > max_t ? max_t / ltn : 1.0f;
        l[0] = lx * scale * active[p];
        l[1] = ly * scale * active[p];
        l[2] = ln * active[p];
      }
      const float ap[3] = {l[0] - lam[p][0], l[1] - lam[p][1],
                           l[2] - lam[p][2]};
      lam[p][0] = l[0]; lam[p][1] = l[1]; lam[p][2] = l[2];
      for (int k = 0; k < nd; ++k)
        jta[k < 6 ? k : lo + k - 6] +=
            Jp[0][k] * ap[0] + Jp[1][k] * ap[1] + Jp[2][k] * ap[2];
    }
    minv_mul(EnvRows{Minv, npad, env}, jta, dgv);
#pragma unroll
    for (int v = 0; v < NV; ++v) gv[v] += dgv[v];
  }

  // advance the points with the clamped velocities
  float gcl[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) gcl[v] = clampf(gv[v], __ldg(vlim + v));
#pragma unroll 1
  for (int p = 0; p < NP; ++p) {
    int lo;
    const int nd = load_jp<SPARSE>(J, p, Jp, &lo, npad, env);
    float v[3];
    jp_dot(Jp, nd, lo, gcl, v);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const size_t o = (size_t)(p * 3 + i) * npad + env;
      pcp_out[o] = __ldg(pcp_in + o) + c.dt * v[i];
      lam_out[o] = lam[p][i];
    }
  }
}
