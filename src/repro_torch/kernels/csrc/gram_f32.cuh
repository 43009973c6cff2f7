// The f32 Gram-tile product of the port's 3xTF32 bodies: the landmark
// tiles of assign_f32.cuh and the f32 tile body of kernel_matrix.cu both
// build their tiles here, so there is one product loop.
//
// A tile is X . Y^T over BM = 128 rows of X [M, D] and BN = 64 rows of Y
// [N, D]. A CTA of NT = 128 threads (four warps, 32 rows each) walks a
// contiguous range [ib, ie) of tiles in row-major (row block, column tile)
// order: tile u covers rows (u / tn) BM and columns (u % tn) BN, tn =
// ceil(N / BN). The (tile, chunk) steps, D in chunks of KC = 32 features,
// form one sequence through a ring of NSTAGE stages: each step copies X
// [BM, KC] and Y [BN, KC] row-major with 16-byte cp.async copies (rows past
// M or N and features past D zero-filled), NSTAGE - 1 steps in flight while
// one is multiplied, one barrier a step. So the next tile's first chunks
// are loading while the caller's epilogue of this tile runs.
//
// The products run as mma.sync m16n8k8 TF32, three per fragment pair
// (common.cuh, 3xTF32), with f32 accumulation. The k index of an m16n8k8
// step is summed over, so any assignment of features to its 8 slots
// serves if A and B agree: slot t takes feature 2t and slot t + 4 feature
// 2t + 1 of each group of 8, so each fragment pair is one float2 read, and
// the 40-float row pitch puts the 16 lanes of a half-warp in distinct
// banks. A warp owns 32 rows x 64 columns, 2 x 8 C-fragments: acc[mi][j][e]
// of lane (g, t) of warp w is row 32 w + 16 mi + g + 8 (e >> 1), column
// 8 j + 2 t + (e & 1) of the tile.
//
// The tensor core's f32 accumulate truncates, so a sum carried through the
// 3 ceil(D / 8) products of a tile loses up to 3 D / 8 units in the last
// place of its largest partial (1.8e-5 of |x|^2 at D = 784, where a
// rounded f32 sum loses a few 1e-7). product<true> (the kernel_matrix
// tile body) therefore sums each ring step's 12 products into a fresh partial
// and adds the partials with f32 adds, a twelfth of that loss; and
// sqnorms_kernel gives |x|^2 by exactly that arithmetic, so that on K(x,
// x)'s diagonal |x|^2 + |x|^2 - 2 x.x is 0. product<false> (assign_f32)
// accumulates straight through: its f feeds a contraction held to 1e-4.
// Built with product<true>, assign_f32 still fits without spills but runs
// slower at each of its shapes in launch/kernel_ab.py (PERF.md §6), so
// it keeps the plain accumulation.
#pragma once

#include "common.cuh"

namespace rt {
namespace gf {

constexpr int NT = 128;              // four warps
constexpr int BM = 128;              // tile rows, 32 a warp
constexpr int BN = 64;               // tile columns
constexpr int KC = 32;               // features per ring step
constexpr int LD = KC + 8;           // row pitch (floats), 8 mod 32
constexpr int NSTAGE = 3;
constexpr int STAGE = (BM + BN) * LD;
constexpr int QPR = KC / 4;          // 16-byte copies per row
constexpr size_t RING_BYTES = sizeof(float) * NSTAGE * STAGE;
static_assert(NT == 16 * QPR, "a thread copies rows cr + 16 u");

// the first of n items that part s of `parts` takes
__host__ __device__ __forceinline__ int range_begin(int s, int parts, int n) {
  return (int)((long long)s * n / parts);
}

struct Ring {
  const float* __restrict__ X;
  const float* __restrict__ Y;
  float* ring;                       // [NSTAGE][BM + BN][LD] shared
  int M, N, D, ncols;                // ncols = tn BN
  // the producer: the next step to copy, its stage and the steps left
  uint32_t dst0;
  int cr, cq;
  int is_r0, is_c0, is_k0, is_stage, left;
  int stage;                         // the consumer's next stage

  // tiles [ib, ie) of the tn column tiles of each row block
  __device__ __forceinline__ Ring(float* ring_, const float* X_,
                                  const float* Y_, int M_, int N_, int D_,
                                  int tn, int ib, int ie)
      : X(X_), Y(Y_), ring(ring_), M(M_), N(N_), D(D_), ncols(tn * BN) {
    // a thread copies features cq .. cq + 3 of the chunk for rows cr + 16 u:
    // X rows (u < 8), then Y rows (u < 4)
    cr = threadIdx.x / QPR;
    cq = (threadIdx.x % QPR) * 4;
    dst0 = smem_addr(ring) + (cr * LD + cq) * 4;
    is_r0 = (ib / tn) * BM;
    is_c0 = (ib % tn) * BN;
    is_k0 = 0;
    is_stage = 0;
    left = (ie - ib) * ((D + KC - 1) / KC);
    stage = 0;
  }

  // copy the next step into its stage; every thread commits one group per
  // call, empty or not
  __device__ __forceinline__ void issue() {
    if (left > 0) {
      const uint32_t st = dst0 + is_stage * STAGE * 4;
      const bool k_ok = is_k0 + cq < D;
      const float* xsrc = X + (size_t)(is_r0 + cr) * D + cq + is_k0;
#pragma unroll
      for (int u = 0; u < BM / 16; ++u) {
        const bool ok = k_ok && is_r0 + cr + 16 * u < M;
        cp_async16(st + 16 * u * LD * 4, ok ? xsrc + (size_t)16 * u * D : X,
                   ok ? 16 : 0);
      }
      const float* ysrc = Y + (size_t)(is_c0 + cr) * D + cq + is_k0;
#pragma unroll
      for (int u = 0; u < BN / 16; ++u) {
        const bool ok = k_ok && is_c0 + cr + 16 * u < N;
        cp_async16(st + (BM + 16 * u) * LD * 4,
                   ok ? ysrc + (size_t)16 * u * D : Y, ok ? 16 : 0);
      }
      --left;
      is_stage = is_stage + 1 == NSTAGE ? 0 : is_stage + 1;
      is_k0 += KC;
      if (is_k0 >= D) {
        is_k0 = 0;
        is_c0 += BN;
        if (is_c0 >= ncols) {
          is_c0 = 0;
          is_r0 += BM;
        }
      }
    }
    cp_commit();
  }

  __device__ __forceinline__ void prime() {
#pragma unroll
    for (int s = 0; s < NSTAGE - 1; ++s) issue();
  }

  // acc = the next tile of the range (all D chunks); every thread calls it.
  // PARTIAL: each ring step's products summed apart, then added to acc.
  template <bool PARTIAL>
  __device__ __forceinline__ void product(float (&acc)[2][8][4]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.0f;
    for (int k0 = 0; k0 < D; k0 += KC) {
      float part[2][8][4];
      float(&sum)[2][8][4] = PARTIAL ? part : acc;
      if (PARTIAL) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mi][j][e] = 0.0f;
      }
      cp_wait<NSTAGE - 2>();   // this step has landed (this thread's copies)
      __syncthreads();         // everyone's; the previous step is multiplied
      issue();                 // NSTAGE - 1 steps ahead, into its stage
      const float* xs = ring + stage * STAGE + (32 * warp + g) * LD + 2 * t;
      const float* ys = ring + stage * STAGE + (BM + g) * LD + 2 * t;
      stage = stage + 1 == NSTAGE ? 0 : stage + 1;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 8) {
        Split a[2][4], b[8][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float2 u =
              *reinterpret_cast<const float2*>(xs + 16 * mi * LD + ks);
          const float2 v =
              *reinterpret_cast<const float2*>(xs + (16 * mi + 8) * LD + ks);
          a[mi][0] = split_tf32(u.x);   // row g,     slot t
          a[mi][1] = split_tf32(v.x);   // row g + 8, slot t
          a[mi][2] = split_tf32(u.y);   // row g,     slot t + 4
          a[mi][3] = split_tf32(v.y);   // row g + 8, slot t + 4
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 w =
              *reinterpret_cast<const float2*>(ys + 8 * j * LD + ks);
          b[j][0] = split_tf32(w.x);
          b[j][1] = split_tf32(w.y);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              mma_3xtf32_part(p, sum[mi][j], a[mi], b[j]);
      }
      if (PARTIAL) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][j][e] += part[mi][j][e];
      }
    }
  }
};

constexpr int SQNORM_WARPS = 4;

// out[r] = |A_r|^2 for the na rows of A [na, D], then out[na + r] = |B_r|^2
// for the nb rows of B, each the diagonal element x.x that
// Ring::product<true> gives for the row against itself: the same split
// values in the same k slots, the same 3xTF32 products per 8 features, the
// same partial per KC features added in the same order. One warp a group
// of 8 rows: lane (g, t) feeds row g as both the A-fragment (rows g + 8
// zero) and the B-fragment of column g, and the diagonal element (g, g) is
// lane (g, g / 2)'s C-fragment element g % 2. A template, so that the
// translation units that include this header share one definition.
template <int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
sqnorms_kernel(const float* __restrict__ A, int na,
               const float* __restrict__ B, int nb, int D,
               float* __restrict__ out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * 8 + g;
  const float* src = row < na ? A + (size_t)row * D
                              : B + (size_t)(row - na) * D;
  const bool ok = row < na + nb;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < D; k0 += KC) {
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < KC; ks += 8) {
      const int k = k0 + ks + 2 * t;   // D is a multiple of 4: k + 1 < D too
      const float2 v = ok && k < D ? *reinterpret_cast<const float2*>(src + k)
                                   : make_float2(0.0f, 0.0f);
      const Split x0 = split_tf32(v.x), x1 = split_tf32(v.y);
      const Split zero = {0u, 0u};
      const Split a[4] = {x0, zero, x1, zero};
      const Split b[2] = {x0, x1};
#pragma unroll
      for (int p = 0; p < 3; ++p) mma_3xtf32_part(p, part, a, b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += part[e];
  }
  if (ok && t == g / 2) out[row] = g % 2 ? acc[1] : acc[0];
}

// launch_sqnorms (common.cuh) with the norms of sqnorms_kernel
inline int launch_tf32_sqnorms(const float* x, int M, const float* y, int N,
                               int D, float* norms, const float** ysq,
                               cudaStream_t stream) {
  const bool same = y == x && N == M;
  const int rows = M + (same ? 0 : N);
  *ysq = same ? norms : norms + M;
  constexpr int ROWS = 8 * SQNORM_WARPS;
  sqnorms_kernel<SQNORM_WARPS><<<(rows + ROWS - 1) / ROWS, 32 * SQNORM_WARPS,
                                 0, stream>>>(
      x, M, y, rows - M, D, norms);
  return (int)cudaGetLastError();
}

}  // namespace gf
}  // namespace rt
