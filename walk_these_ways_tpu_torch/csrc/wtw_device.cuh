// Device helpers shared by the port's CUDA kernels (csrc/*.cu): small 3-vector
// and 3x3 arithmetic, row accessors, the M^-1 product, the heightfield
// sample and the contact rows' updates.
//
// Include after the generated "wtw_topology.h" (ops/_build.py writes it into
// the build directory).  That header always defines MS_NV and MS_P, and
// with the robot's topology (MS_NB, MS_NJ and the __constant__ tables) the
// sizes below.
//
// Every operand in global memory is env-minor: element `row` of env `env`
// lives at ptr[row * npad + env], so a warp reads 32 neighbouring floats.
#pragma once
#include <cuda_runtime.h>

#define NV MS_NV
#define NP MS_P
#ifdef MS_NB
#define NB MS_NB
#define NJ MS_NJ
#define GM MS_GMAX        // most leg dofs a contact point depends on
#define NH MS_H           // actuator network: hidden units, inputs per joint
#define NF MS_F
#endif

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float softsign(float x) {
  return x / (1.0f + fabsf(x));
}

__device__ __forceinline__ float clampf(float x, float lim) {
  return fminf(fmaxf(x, -lim), lim);
}

// M9 row-major 3x3, v (3) -> M v
__device__ __forceinline__ void m3v(const float* M, const float* v, float* o) {
  o[0] = M[0] * v[0] + M[1] * v[1] + M[2] * v[2];
  o[1] = M[3] * v[0] + M[4] * v[1] + M[5] * v[2];
  o[2] = M[6] * v[0] + M[7] * v[1] + M[8] * v[2];
}

// M^T v
__device__ __forceinline__ void m3tv(const float* M, const float* v,
                                     float* o) {
  o[0] = M[0] * v[0] + M[3] * v[1] + M[6] * v[2];
  o[1] = M[1] * v[0] + M[4] * v[1] + M[7] * v[2];
  o[2] = M[2] * v[0] + M[5] * v[1] + M[8] * v[2];
}

// Row accessors.  M^-1 is read through one of these, so that a kernel that
// reads the cache from global memory and one that builds it itself share
// one copy of the code that reads it.
//
// EnvRows: an env-minor operand in global memory that no thread writes during
// the launch, read through the read-only data path (__ldg).
struct EnvRows {
  const float* __restrict__ p;
  size_t npad;
  int env;
  __device__ __forceinline__ float operator[](int row) const {
    return __ldg(p + (size_t)row * npad + env);
  }
};

// ThreadRows: an array that the kernel itself writes (the warp-per-env
// kernels' cache in shared memory), read with ordinary loads: the
// read-only path is not coherent with the kernel's own stores.  `npad` and
// `env` are ignored; they keep the two accessors constructible alike.
struct ThreadRows {
  const float* p;
  size_t npad;
  int env;
  __device__ __forceinline__ float operator[](int row) const { return p[row]; }
};

// out[w] = sum_v Minv[w][v] * x[v]; row w * NV + v of `Minv` is Minv[w][v]
template <class Rows>
__device__ __forceinline__ void minv_mul(const Rows& Minv, const float* x,
                                         float* out) {
#pragma unroll 1
  for (int w = 0; w < NV; ++w) {
    float acc = 0.0f;
#pragma unroll
    for (int v = 0; v < NV; ++v) acc += Minv[w * NV + v] * x[v];
    out[w] = acc;
  }
}

// x^T M x for a row-major 3x3 M, summed as the JAX package sums n^T W n
// and t^T W t: x0 (M0 x0 + M1 x1 + M2 x2) + x1 (...) + x2 (...)
__device__ __forceinline__ float quad3(const float* M, const float* x) {
  return x[0] * (M[0] * x[0] + M[1] * x[1] + M[2] * x[2])
       + x[1] * (M[3] * x[0] + M[4] * x[1] + M[5] * x[2])
       + x[2] * (M[6] * x[0] + M[7] * x[1] + M[8] * x[2]);
}

// Unit surface normal of contact point p: env-minor (P, 3, npad) operand
// that no thread writes during the launch.
__device__ __forceinline__ void load_normal(const float* __restrict__ n,
                                            int p, size_t npad, int env,
                                            float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = __ldg(n + (size_t)(p * 3 + i) * npad + env);
}

// Bilinear height h and unit surface normal n of a heightfield at world
// (x, y): physics/engine.Terrain.lookup statement by statement, on its
// corner-packed table `corners` ((rows, cols, 4) = the field's (H - 1,
// W - 1) cells, (h[i,j], h[i+1,j], h[i,j+1], h[i+1,j+1]) each; read-only
// for the launch), grid pitch `hs` and grid origin (ox, oy).  Queries
// outside the field take the border cell's plane clamped to its edge.
__device__ __forceinline__ void heightfield_sample(
    const float* __restrict__ corners, int rows, int cols, float hs,
    float ox, float oy, float x, float y, float& h, float* n) {
  const float gx = (x - ox) / hs;
  const float gy = (y - oy) / hs;
  const int i0 = min(max((int)floorf(gx), 0), rows - 1);
  const int j0 = min(max((int)floorf(gy), 0), cols - 1);
  const float fx = fminf(fmaxf(gx - (float)i0, 0.0f), 1.0f);
  const float fy = fminf(fmaxf(gy - (float)j0, 0.0f), 1.0f);
  const float* c = corners + 4 * ((size_t)i0 * cols + j0);
  const float h00 = __ldg(c), h10 = __ldg(c + 1), h01 = __ldg(c + 2),
              h11 = __ldg(c + 3);
  h = h00 * (1.0f - fx) * (1.0f - fy) + h10 * fx * (1.0f - fy)
    + h01 * (1.0f - fx) * fy + h11 * fx * fy;
  const float dhdx = ((h10 - h00) * (1.0f - fy) + (h11 - h01) * fy) / hs;
  const float dhdy = ((h01 - h00) * (1.0f - fx) + (h11 - h10) * fx) / hs;
  const float nx = -dhdx, ny = -dhdy, nz = 1.0f;
  const float s = sqrtf(nx * nx + ny * ny + nz * nz);
  n[0] = nx / s; n[1] = ny / s; n[2] = nz / s;
}

// One contact point's row update in a projected-Jacobi sweep on a surface of
// unit normal n: the general-normal branch of the JAX package's
// ops/pallas_contact.py::contact_core.  The normal row drives n.v to
// `target` (inv_wnn = relax / n^T W n), the friction row pushes against the
// 3-D slip t = (v - (n.v) n) / |...| with scalar mass t^T W t (floored at
// 1e-6), and the tangential part of the total impulse is clamped to the
// mu * lambda_n cone.  W: the point's row-major 3x3 effective mass.  lam:
// in the total impulse, out the new one (zero where the point is not
// `active`).
__device__ __forceinline__ void normal_row_update(
    const float* v, const float* n, const float* W, float target,
    float inv_wnn, float relax, float mu, float active, float* lam) {
  const float vn = n[0] * v[0] + n[1] * v[1] + n[2] * v[2];
  const float vtx = v[0] - vn * n[0];
  const float vty = v[1] - vn * n[1];
  const float vtz = v[2] - vn * n[2];
  const float vtn = sqrtf(vtx * vtx + vty * vty + vtz * vtz + 1e-18f);
  const float itn = 1.0f / vtn;
  const float t[3] = {vtx * itn, vty * itn, vtz * itn};
  const float w_tt = fmaxf(quad3(W, t), 1e-6f);
  const float dln = (target - vn) * inv_wnn;
  const float dlt = -relax * vtn / w_tt;
  const float l_n0 = lam[0] * n[0] + lam[1] * n[1] + lam[2] * n[2];
  const float ln = fmaxf(l_n0 + dln, 0.0f);
  const float lx = lam[0] - l_n0 * n[0] + dlt * t[0];
  const float ly = lam[1] - l_n0 * n[1] + dlt * t[1];
  const float lz = lam[2] - l_n0 * n[2] + dlt * t[2];
  const float ltn = sqrtf(lx * lx + ly * ly + lz * lz + 1e-18f);
  const float max_t = mu * ln;
  const float scale = ltn > max_t ? max_t / ltn : 1.0f;
  lam[0] = (ln * n[0] + lx * scale) * active;
  lam[1] = (ln * n[1] + ly * scale) * active;
  lam[2] = (ln * n[2] + lz * scale) * active;
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
