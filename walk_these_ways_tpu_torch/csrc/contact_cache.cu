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
// Design for this card.  A block owns a tile of CC_ENVS neighbouring envs,
// the env on the fast thread index, and CC_SLOTS point slots; thread (slot,
// env) takes the points slot, slot + CC_SLOTS, ...:
//   - staging: the tile's Sw, Sv and M^-1 go into shared memory once, a row
//     at a time, CC_ENVS neighbouring threads reading one row's neighbouring
//     floats; every point of an env then reads them from there (M^-1 is read
//     from device memory once per env, not once per point and row);
//   - columns: `anc` is an operand, as in the TPU kernel.  At block start
//     each point's list of nonzero columns (ascending) and their mask
//     values go into shared memory; a thread forms J only on its point's
//     columns (the loops unrolled to NV and cut at the list's length) and
//     writes exact zeros for the others, since J stays dense;
//   - W: t_i = J_i M^-1 for the three rows at once over the point's columns
//     only (the 9 x 9 block of M^-1 for a leg point, 6 x 6 for a trunk
//     point), t in registers, then W_ij = J_j . t_i with each J column made
//     again from shared memory (the same statements, so the same bits:
//     holding J in registers beside t spilled).  A column that `anc`
//     zeroes adds only +-0 to these sums, so skipping it is exact, and the
//     sums keep the order of ascending dofs;
//   - stores: the dense J (P*3*nv floats per env, most of the bytes) and W
//     go out row by row, CC_ENVS neighbouring floats a store.
//
// Bound on this card: the dense J (P*3*nv floats per env) and W (P*9) must be
// written once, and Sw, Sv, M^-1, r read once: about 9.1 KB per env against
// about 0.02 MFLOP, so the least time is set by bytes.  The measured numbers
// are kept in PERF.md.
#include <cuda_runtime.h>
#include "wtw_topology.h"
#include "wtw_device.cuh"

#define CC_ENVS 16                   // envs per block (fast thread index)
#define CC_SLOTS ((NP + 1) / 2)      // point slots per block
#define CC_THREADS (CC_ENVS * CC_SLOTS)
#define CC_MIN_BLOCKS 2              // resident blocks asked of ptxas
#define CC_PACK ((NV + 3) / 4)       // a point's column list, 4 bytes a word

static_assert(NV <= 64, "a column index fits in a byte, the set in 64 bits");

enum InIdx { I_ANC = 0, I_SW, I_SV, I_MINV, I_R, N_IN };
enum OutIdx { O_J = 0, O_W, N_OUT };
enum FIdx { F_EPS = 0, N_F };

struct CacheArgs {
  const float* in[N_IN];
  float* out[N_OUT];
  float eps;
  int npad;
};

// One block's shared memory: the tile's operands, env-minor (row, env), and
// the points' column lists.
struct CacheTile {
  float sw[NV * 3][CC_ENVS], sv[NV * 3][CC_ENVS];
  float minv[NV * NV][CC_ENVS];
  unsigned cols[NP][CC_PACK];        // nonzero columns, ascending
  float mval[NP][NV];                // anc at those columns
  int ncol[NP];
};

// Rows [0, rows) of the env-minor operand `src` into dst[row][env] for the
// tile's envs, CC_ENVS neighbouring threads reading one row's neighbouring
// floats.
__device__ __forceinline__ void stage_tile(float (*dst)[CC_ENVS],
                                           const float* __restrict__ src,
                                           int rows, size_t npad, int env0) {
  for (int k = threadIdx.x; k < rows * CC_ENVS; k += CC_THREADS) {
    const int row = k / CC_ENVS, e = k % CC_ENVS;
    dst[row][e] = __ldg(src + (size_t)row * npad + env0 + e);
  }
}

__device__ __forceinline__ int column(const unsigned* cols, int k) {
  return (cols[k / 4] >> (8 * (k % 4))) & 0xffu;
}

// Column k (dof v) of point p's J at the tile's env e, contact offset r
__device__ __forceinline__ void j_column(const CacheTile& tile, int p, int k,
                                         int v, int e, const float* r,
                                         float* j) {
  const float m = tile.mval[p][k];
  float sw[3], sv[3], c[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    sw[i] = tile.sw[v * 3 + i][e];
    sv[i] = tile.sv[v * 3 + i][e];
  }
  cross3(sw, r, c);
#pragma unroll
  for (int i = 0; i < 3; ++i) j[i] = m * (sv[i] + c[i]);
}

__global__ void __launch_bounds__(CC_THREADS, CC_MIN_BLOCKS)
contact_cache_kernel(const CacheArgs a) {
  __shared__ CacheTile tile;
  // the grid covers npad exactly (the launcher checks that CC_ENVS divides
  // it), so every thread reaches the __syncthreads
  const int e = threadIdx.x % CC_ENVS, slot = threadIdx.x / CC_ENVS;
  const int env0 = blockIdx.x * CC_ENVS, env = env0 + e;
  const size_t npad = (size_t)a.npad;

  // ---- the tile's operands and the points' column lists ----
  stage_tile(tile.sw, a.in[I_SW], NV * 3, npad, env0);
  stage_tile(tile.sv, a.in[I_SV], NV * 3, npad, env0);
  stage_tile(tile.minv, a.in[I_MINV], NV * NV, npad, env0);
  for (int p = threadIdx.x; p < NP; p += CC_THREADS) {
    unsigned packed[CC_PACK];
#pragma unroll
    for (int w = 0; w < CC_PACK; ++w) packed[w] = 0u;
    int n = 0;
    for (int v = 0; v < NV; ++v) {
      const float m = __ldg(a.in[I_ANC] + p * NV + v);
      if (m != 0.0f) {
        packed[n / 4] |= (unsigned)v << (8 * (n % 4));
        tile.mval[p][n] = m;
        ++n;
      }
    }
#pragma unroll
    for (int w = 0; w < CC_PACK; ++w) tile.cols[p][w] = packed[w];
    tile.ncol[p] = n;
  }
  __syncthreads();

#pragma unroll 1
  for (int p = slot; p < NP; p += CC_SLOTS) {
    const int n = tile.ncol[p];
    unsigned cols[CC_PACK];
#pragma unroll
    for (int w = 0; w < CC_PACK; ++w) cols[w] = tile.cols[p][w];
    float r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      r[i] = __ldg(a.in[I_R] + (size_t)(p * 3 + i) * npad + env);

    // t_i[b] = sum_a J[i][a] Minv[col a][col b], the three rows at once;
    // each J column is written out as it is made, zeros elsewhere
    float t[3][NV];
#pragma unroll
    for (int b = 0; b < NV; ++b) t[0][b] = t[1][b] = t[2][b] = 0.0f;
    unsigned long long set = 0ull;
#pragma unroll
    for (int ka = 0; ka < NV; ++ka) {
      if (ka < n) {
        const int v = column(cols, ka);
        float j[3];
        j_column(tile, p, ka, v, e, r, j);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          a.out[O_J][((size_t)(p * 3 + i) * NV + v) * npad + env] = j[i];
        set |= 1ull << v;
        const float* row = &tile.minv[v * NV][e];
#pragma unroll
        for (int kb = 0; kb < NV; ++kb) {
          if (kb < n) {
            const float mm = row[column(cols, kb) * CC_ENVS];
            t[0][kb] += j[0] * mm;
            t[1][kb] += j[1] * mm;
            t[2][kb] += j[2] * mm;
          }
        }
      }
    }
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!((set >> v) & 1ull)) {
#pragma unroll
        for (int i = 0; i < 3; ++i)
          a.out[O_J][((size_t)(p * 3 + i) * NV + v) * npad + env] = 0.0f;
      }
    }
    // W[i][jj] = sum_b J[jj][b] t_i[b] (J's column b made again, to the
    // bit), + eps on the diagonal
    float w[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f},
                     {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int kb = 0; kb < NV; ++kb) {
      if (kb < n) {
        float j[3];
        j_column(tile, p, kb, column(cols, kb), e, r, j);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) w[i][jj] += j[jj] * t[i][kb];
      }
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w[i][i] += a.eps;
#pragma unroll
      for (int jj = 0; jj < 3; ++jj)
        a.out[O_W][(size_t)(p * 9 + i * 3 + jj) * npad + env] = w[i][jj];
    }
  }
}

// Plain C interface for ctypes.  `in` = {anc (P, nv), Sw (nv, 3, npad),
// Sv (nv, 3, npad), Minv (nv, nv, npad), r (P, 3, npad)}, `out` = {J (P, 3,
// nv, npad), W (P, 9, npad)}, `f` = {eps}, `ip` = {npad, threads per block}.
// `threads` must be CC_THREADS and npad a multiple of CC_ENVS.  Launches on
// `stream`, does not synchronise, returns the launch's cudaError_t (0 =
// launched).
extern "C" int contact_cache_launch(const void* const* in, void* const* out,
                                    const float* f, const int* ip,
                                    void* stream) {
  CacheArgs a;
  for (int i = 0; i < N_IN; ++i) a.in[i] = static_cast<const float*>(in[i]);
  for (int i = 0; i < N_OUT; ++i) a.out[i] = static_cast<float*>(out[i]);
  a.eps = f[F_EPS];
  a.npad = ip[0];
  const int threads = ip[1];
  if (threads != CC_THREADS || a.npad < 1 || a.npad % CC_ENVS)
    return (int)cudaErrorInvalidValue;
  const int blocks = a.npad / CC_ENVS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  contact_cache_kernel<<<blocks, threads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* contact_cache_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int contact_cache_counts(int* n_in, int* n_out, int* n_f) {
  *n_in = N_IN; *n_out = N_OUT; *n_f = N_F;
  return 0;
}

// Resident blocks per SM into blocks[0], the threads and static shared
// memory per block (CC_ENVS envs); returns the cudaError_t.
extern "C" int contact_cache_occupancy(int* blocks, int* threads,
                                       int* smem_bytes) {
  *threads = CC_THREADS;
  *smem_bytes = (int)sizeof(CacheTile);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks[0], contact_cache_kernel, CC_THREADS, 0);
}
