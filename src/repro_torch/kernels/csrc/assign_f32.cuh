// The f32 body of assign.cu: 3xTF32 on the tensor cores, the landmark axis
// split over CTAs so the grid fills the card, a cp.async ring.
//
// Grid (splits, row blocks); split s of S takes the landmark tiles
// [s T / S, (s + 1) T / S) of the T = ceil(L / BN) tiles (gf::range_begin; the
// launcher, kernels/assign.py landmark_splits, picks S from M, L, the SM
// count and the CTAs an SM holds, which rt_assign_f32_ctas_per_sm
// reports). One CTA of four warps owns BM = 128 rows, 32 a warp, and
// walks over its tiles of BN = 64 landmarks. Its Gram tiles X . L^T come
// from gram_f32.cuh (the product loop the kernel_matrix f32 tile body
// shares): a cp.async ring whose steps run on across the split's tiles,
// 3xTF32 mma.sync with f32 accumulation. A row block's splits are
// adjacent in launch order, so the CTAs resident at once share a few row
// blocks of X and stream their own landmark ranges. The kernel is
// instantiated per Mercer kind, so the epilogue on its 64 accumulators
// compiles to one formula (no spills at two CTAs per SM).
//
// After each tile, the epilogue runs on the accumulators (columns past L
// zeroed), and the tile is contracted against H [L, Cp] at once, also in
// 3xTF32: the C-fragment of landmark tile j holds columns 2t and 2t + 1
// for rows g and g + 8, which is the A-fragment of a k step whose slots t
// and t + 4 are landmarks 2t and 2t + 1, so the tile needs no shuffle and
// no trip through shared memory; H's B-fragments are read from global
// memory (L1 / L2 resident).
// The partial f [BM, Cp] of a warp's rows lives in shared memory, each
// element owned by one lane, across the split's tiles; after the last it
// is written to part [S, M, Cp]. assign_reduce_kernel then sums the splits
// in order 0, 1, ..., writes F, and takes mind = min_j (g_j - 2 F_ij) and
// its lowest index, one warp a row: no atomics, so two launches give the
// same bits.
#pragma once

#include "epilogue.cuh"
#include "gram_f32.cuh"

namespace rt {
namespace af {

using gf::BM;                        // rows per CTA, 32 a warp
using gf::BN;                        // landmarks per tile
using gf::NT;                        // four warps
constexpr int FS_PAD = 8;            // f row pitch Cp + 8
constexpr int REDUCE_ROWS = 8;       // rows per block of the reduction
constexpr unsigned FULL = 0xffffffffu;

inline size_t smem_bytes(int cp) {
  return gf::RING_BYTES + sizeof(float) * (size_t)BM * (cp + FS_PAD);
}

template <int KIND>
__global__ void __launch_bounds__(NT, 2)
assign_f32_kernel(const float* __restrict__ X, const float* __restrict__ Lm,
                  const float* __restrict__ xsq,
                  const float* __restrict__ lsq,
                  const float* __restrict__ H, float* __restrict__ part,
                  int M, int L, int D, int Cp, Epilogue epi) {
  extern __shared__ __align__(16) float sm[];   // the ring, then f
  const int FP = Cp + FS_PAD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BM;
  const int wr = 32 * warp;                   // the warp's first row
  // the warp's rows of f; lane (g, t) owns columns 2t, 2t + 1 of each 8
  // in rows g, g + 8, g + 16, g + 24
  float* fw = sm + gf::NSTAGE * gf::STAGE + wr * FP;
  for (int c = 2 * t; c < Cp; c += 8)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float2*>(fw + (g + 8 * i) * FP + c) =
          make_float2(0.0f, 0.0f);

  const int tiles = (L + BN - 1) / BN;
  const int tb = gf::range_begin(blockIdx.x, gridDim.x, tiles);
  const int te = gf::range_begin(blockIdx.x + 1, gridDim.x, tiles);

  float xs_n[4];                              // |x|^2 of rows g + 8 i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = r0 + wr + g + 8 * i;
    xs_n[i] = gr < M ? __ldg(xsq + gr) : 0.0f;
  }

  // the split's tiles of this row block, in the row-major order of the
  // ring's (row block, landmark tile) walk
  gf::Ring ring(sm, X, Lm, M, L, D, tiles, blockIdx.y * tiles + tb,
                blockIdx.y * tiles + te);
  ring.prime();
  for (int l0 = tb * BN; l0 < te * BN; l0 += BN) {
    float acc[2][8][4];                       // [row tile][landmark tile]
    ring.product<false>(acc);

    // the tile is complete: epilogue on the accumulators, columns past L
    // zeroed (an epilogue need not be 0 there: rbf gives exp(-gamma |x|^2))
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = l0 + 8 * j + 2 * t + e;
        const float ys = gc < L ? __ldg(lsq + gc) : 0.0f;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& v = acc[mi][j][2 * h + e];
            v = gc < L ? mercer<KIND>(epi, v, xs_n[2 * mi + h], ys) : 0.0f;
          }
      }
    }
    // f += tile . H[l0 : l0 + BN], 16 cluster columns at a time; landmark
    // tile j of the C-fragments is k step j of the A-fragments
    for (int p0 = 0; p0 < Cp; p0 += 16) {
      float f[2][2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[mi][n][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int la = l0 + 8 * j + 2 * t;   // slot t; slot t + 4 is la + 1
        Split a[2][4], b[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* hp = H + (size_t)la * Cp + p0 + 8 * n + g;
          b[n][0] = split_tf32(la < L ? __ldg(hp) : 0.0f);
          b[n][1] = split_tf32(la + 1 < L ? __ldg(hp + Cp) : 0.0f);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          a[mi][0] = split_tf32(acc[mi][j][0]);
          a[mi][1] = split_tf32(acc[mi][j][2]);
          a[mi][2] = split_tf32(acc[mi][j][1]);
          a[mi][3] = split_tf32(acc[mi][j][3]);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mma_3xtf32_part(p, f[mi][n], a[mi], b[n]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float2* q = reinterpret_cast<float2*>(
                fw + (16 * mi + 8 * h + g) * FP + p0 + 8 * n + 2 * t);
            float2 cur = *q;
            cur.x += f[mi][n][2 * h];
            cur.y += f[mi][n][2 * h + 1];
            *q = cur;
          }
    }
  }

  // this split's f for the warp's rows (each lane its own elements)
  float* out = part + ((size_t)blockIdx.x * M + r0 + wr) * Cp;
  for (int c = 2 * t; c < Cp; c += 8)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (r0 + wr + g + 8 * i < M)
        *reinterpret_cast<float2*>(out + (size_t)(g + 8 * i) * Cp + c) =
            *reinterpret_cast<const float2*>(fw + (g + 8 * i) * FP + c);
}

// F = sum over splits of part (in split order), mind = min_j (g_j - 2
// F_ij) and its lowest index; one warp a row, ROWS (REDUCE_ROWS) rows a
// block. F may be part itself: each element is read before it is written,
// by the same lane. A template, as embed_assign.cu launches it too.
template <int ROWS>
__global__ void __launch_bounds__(32 * ROWS)
assign_reduce_kernel(const float* part, int splits,
                     const float* __restrict__ g, float* F,
                     int* __restrict__ labels, float* __restrict__ mind,
                     int M, int Cp) {
  const int row = blockIdx.x * ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  float best = 0.0f;
  int arg = -1;   // none yet
  for (int c = lane; c < Cp; c += 32) {
    float f = part[(size_t)row * Cp + c];
    for (int s = 1; s < splits; ++s) f += part[((size_t)s * M + row) * Cp + c];
    F[(size_t)row * Cp + c] = f;
    const float d = __ldg(g + c) - 2.0f * f;
    if (arg < 0 || d < best) {
      best = d;
      arg = c;
    }
  }
  // the first strict minimum over the row: the lowest index wins ties
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(FULL, best, o);
    const int oa = __shfl_xor_sync(FULL, arg, o);
    if (oa >= 0 && (arg < 0 || ob < best || (ob == best && oa < arg))) {
      best = ob;
      arg = oa;
    }
  }
  if (lane == 0) {
    labels[row] = arg;
    mind[row] = best;
  }
}

// norms [M + L] f32 scratch: the row norms of x and l (common.cuh
// launch_sqnorms)
template <int KIND>
static int launch(const float* x, const float* l, float* norms,
                  const float* h, const float* g, int* labels, float* mind,
                  float* f, float* part, int M, int L, int D, int Cp,
                  int splits, const Epilogue& epi, cudaStream_t stream) {
  const int tiles = (L + BN - 1) / BN;
  if (M <= 0 || L <= 0 || splits < 1 || splits > tiles)
    return (int)cudaErrorInvalidValue;
  auto kernel = assign_f32_kernel<KIND>;
  cudaError_t err = smem_once<assign_f32_kernel<KIND>>(smem_bytes(MAX_CP),
                                                       true);
  if (err != cudaSuccess) return (int)err;
  const float* lsq = nullptr;
  if ((err = (cudaError_t)launch_sqnorms(x, M, l, L, D, norms, &lsq,
                                         stream)) != cudaSuccess)
    return (int)err;
  kernel<<<dim3(splits, (M + BM - 1) / BM), NT, smem_bytes(Cp), stream>>>(
      x, l, norms, lsq, h, part, M, L, D, Cp, epi);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  assign_reduce_kernel<REDUCE_ROWS><<<(M + REDUCE_ROWS - 1) / REDUCE_ROWS,
                                      32 * REDUCE_ROWS, 0, stream>>>(
      part, splits, g, f, labels, mind, M, Cp);
  return (int)cudaGetLastError();
}

// CTAs of kind KIND's instantiation one SM holds at Cp clusters
template <int KIND>
static int ctas_per_sm(int Cp, int* out) {
  const cudaError_t err =
      smem_once<assign_f32_kernel<KIND>>(smem_bytes(MAX_CP), true);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, assign_f32_kernel<KIND>, NT, smem_bytes(Cp));
}

// one instantiation per Mercer kind
static int dispatch(const float* x, const float* l, float* norms,
                    const float* h, const float* g, int* labels, float* mind,
                    float* f, float* part, int M, int L, int D, int Cp,
                    int splits, const Epilogue& epi, cudaStream_t stream) {
#define RT_AF_CASE(K)                                                   \
  case K:                                                               \
    return launch<K>(x, l, norms, h, g, labels, mind, f, part, M, L, D, \
                     Cp, splits, epi, stream);
  switch (epi.kind) {
    RT_AF_CASE(LINEAR)
    RT_AF_CASE(POLYNOMIAL)
    RT_AF_CASE(COSINE)
    RT_AF_CASE(RBF)
  }
#undef RT_AF_CASE
  return (int)cudaErrorInvalidValue;
}

static int dispatch_ctas_per_sm(int kind, int Cp, int* out) {
  switch (kind) {
    case LINEAR: return ctas_per_sm<LINEAR>(Cp, out);
    case POLYNOMIAL: return ctas_per_sm<POLYNOMIAL>(Cp, out);
    case COSINE: return ctas_per_sm<COSINE>(Cp, out);
    case RBF: return ctas_per_sm<RBF>(Cp, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace af
}  // namespace rt
