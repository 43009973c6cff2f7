// kernel_matrix: K(X, Y) = epilogue(X . Y^T) -> [M, N] f32.
//
// Replaces the TPU kernel kernel_matrix_pallas
// (src/repro/kernels/kernel_matrix.py:78, bodies _kernel :45 and the
// epilogue _epilogue :31-42): the same tiled Gram block with f32
// accumulation and an in-register epilogue for rbf, polynomial, cosine or
// linear, computed from the row squared norms |x|^2 [M] and |y|^2 [N].
//
// What bounds it on an H100 depends on N, so there are two bodies:
//   tile bodies (N > NCOL_MAX of kernels/kernel_matrix.py): operations at
//     f32. One [M, N] block costs 2*M*N*D flops against (M+N)*D operand
//     reads and M*N f32 writes; at the Gram build's [15000 x 3000 x 784]
//     that is ~220 flops per byte moved, far above the ridge of
//     f32-accurate 3xTF32 on the tensor cores (165 TFLOP/s over 3.35 TB/s:
//     ~50 flops a byte). At bf16 the same work takes 0.071 ms on the tensor
//     cores and the 180 MB of K take 0.054 ms to write, so the bf16 body is
//     bound by its products and its stores about equally. Each dtype takes
//     the Gram-tile product loop of its assign_fused body, shared, not
//     copied:
//       f32 (gram_f32.cuh): tiles of 128 x 64 from a 3-stage cp.async
//         ring, 3xTF32 mma.sync m16n8k8, four warps;
//       bf16 (gram_bf16.cuh): tiles of 128 x 128 from a 3-stage TMA ring
//         with 128-byte swizzle, wgmma m64n128k16, two warpgroups.
//     The launch first sums |x|^2 and |y|^2 from the stored values, so the
//     wrapper computes no norms: at f32 with gram_f32.cuh
//     launch_tf32_sqnorms (the same split values, k slots and per-step
//     partials as Ring::product<true>, so the rbf diagonal of K(x, x) is
//     exactly 1), at bf16 with common.cuh row_sqnorms_kernel (f32 sums, as
//     the assign_fused entries do). The epilogue runs on the accumulators
//     in registers, instantiated per Mercer kind so that each body meets
//     one formula. The tile then goes out through a small per-warp buffer
//     in shared memory (16 rows x 64 columns at f32, 8 x 32 at bf16, so
//     two CTAs still fit beside their rings) and leaves it as whole row
//     runs: 16-byte stores where N is a multiple of 4 (rows start 16-byte
//     aligned), 4-byte ones otherwise, so every 32-byte sector of K is
//     written whole, once, where the fragment layout would scatter a warp's
//     store over 8 rows. Rows past M and columns past N are dropped.
//     Grid: persistent, sized to the SMs times the CTAs one SM holds (two:
//     ~110 KB of shared memory each, at most 255 and 128 registers), each
//     CTA walking an equal contiguous range of tiles in row-major order
//     (kernels/kernel_matrix.py tile_ctas). The ring runs on across the
//     range, so each tile's first chunks load during the previous one's
//     epilogue and stores, and the second CTA on the SM multiplies while
//     the first runs its exp epilogue and stores: a grid of one CTA a
//     tile would restart the ring on every tile and leave the last wave
//     part empty.
//   column body (N <= NCOL_MAX: the k-means++ columns [M, 1..5] and the
//     Eq.8 / predict blocks [M, 10]): bytes. 2*N flops per element of X
//     against the 4 (f32) or 2 (bf16) bytes of reading it, far below the
//     ridge, so the least time is X read once: 14 us for 15000 x 784 f32.
//     A tile of 128 columns would do 128/N times the work and a norm pass
//     would read X a second time. Instead each CTA stages Y [N,
//     D] in shared memory once (as f32, columns past N zero) and sums |y|^2
//     there, and each group of LPR lanes (a warp for wide rows, 8 for
//     narrow ones) streams R rows of X at a time with 16-byte loads, lane
//     l of the group holding features 4l (f32) or 8l (bf16) of every 4 LPR
//     or 8 LPR; it accumulates the N dot products and |x|^2 of its rows in
//     f32 from the same loaded values (bf16 lifted to f32 first, as the
//     reference accumulates), sums them over the group's lanes with
//     shuffles, and stores N values a row after the epilogue. The grid is
//     sized to the CTAs the card holds at once, each walking over row
//     groups, so Y is staged once per CTA.
#include <algorithm>

#include "gram_bf16.cuh"
#include "gram_f32.cuh"
#include "epilogue.cuh"

namespace rt {

// ---- tile bodies -----------------------------------------------------------

namespace tile {

// the widest of a warp's stores: 16-byte vectors when rows of N floats
// start 16-byte aligned, else single floats; rows [gr0, gr0 + ROWS) and
// columns [gc0, gc0 + COLS) of out [M, N] from the warp's buffer stg (row
// pitch ld floats), rows past M and columns past N dropped
template <int ROWS, int COLS>
__device__ __forceinline__ void warp_store(const float* stg, int ld,
                                           float* __restrict__ out, int gr0,
                                           int gc0, int M, int N) {
  const int lane = threadIdx.x & 31;
  if ((N & 3) == 0) {
    constexpr int V4 = COLS / 4;   // 16-byte vectors a row
#pragma unroll
    for (int i = lane; i < ROWS * V4; i += 32) {
      const int r = i / V4, c = (i % V4) * 4;
      if (gr0 + r < M && gc0 + c < N)
        *reinterpret_cast<float4*>(out + (size_t)(gr0 + r) * N + gc0 + c) =
            *reinterpret_cast<const float4*>(stg + r * ld + c);
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < ROWS * COLS; i += 32) {
      const int r = i / COLS, c = i % COLS;
      if (gr0 + r < M && gc0 + c < N)
        out[(size_t)(gr0 + r) * N + gc0 + c] = stg[r * ld + c];
    }
  }
}

// ---- f32: 3xTF32 tiles of 128 x 64 (gram_f32.cuh) --------------------------

constexpr int F32_SLD = gf::BN + 8;            // buffer pitch, 8 mod 32
constexpr size_t F32_STAGE_BYTES =             // 16 x 64 floats a warp
    sizeof(float) * (gf::NT / 32) * 16 * F32_SLD;
constexpr size_t F32_SMEM = gf::RING_BYTES + F32_STAGE_BYTES;

template <int KIND>
__global__ void __launch_bounds__(gf::NT, 2)
tile_f32_kernel(const float* __restrict__ X, const float* __restrict__ Y,
                const float* __restrict__ xsq, const float* __restrict__ ysq,
                float* __restrict__ out, int M, int N, int D, Epilogue epi) {
  extern __shared__ __align__(16) float sm[];   // the ring, then the buffers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tn = (N + gf::BN - 1) / gf::BN;
  const int tiles = (M + gf::BM - 1) / gf::BM * tn;
  const int ib = gf::range_begin(blockIdx.x, gridDim.x, tiles);
  const int ie = gf::range_begin(blockIdx.x + 1, gridDim.x, tiles);
  float* stg = sm + gf::NSTAGE * gf::STAGE + warp * 16 * F32_SLD;
  gf::Ring ring(sm, X, Y, M, N, D, tn, ib, ie);
  ring.prime();
  for (int u = ib; u < ie; ++u) {
    const int r0 = u / tn * gf::BM + 32 * warp;   // the warp's first row
    const int c0 = u % tn * gf::BN;
    float acc[2][8][4];
    ring.product<true>(acc);
    float ys[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gc = c0 + 8 * j + 2 * t + e;
        ys[j][e] = gc < N ? __ldg(ysq + gc) : 0.0f;
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      // rows 16 mi .. 16 mi + 15 of the warp: epilogue, then through the
      // buffer
      float xs[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gr = r0 + 16 * mi + 8 * h + g;
        xs[h] = gr < M ? __ldg(xsq + gr) : 0.0f;
      }
      __syncwarp();   // the buffer's previous rows have left
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(stg + (8 * h + g) * F32_SLD + 8 * j +
                                     2 * t) =
              make_float2(
                  mercer<KIND>(epi, acc[mi][j][2 * h], xs[h], ys[j][0]),
                  mercer<KIND>(epi, acc[mi][j][2 * h + 1], xs[h],
                                     ys[j][1]));
      __syncwarp();
      warp_store<16, gf::BN>(stg, F32_SLD, out, r0 + 16 * mi, c0, M, N);
    }
  }
}

// ---- bf16: wgmma tiles of 128 x 128 (gram_bf16.cuh) ------------------------

constexpr int BF16_SLD = 32 + 8;               // buffer pitch, 8 mod 32
constexpr size_t BF16_STAGE_BYTES =            // 8 x 32 floats a warp
    sizeof(float) * gb::NWARPS * 8 * BF16_SLD;
// 1024 to align the ring to the swizzle period
constexpr size_t BF16_SMEM =
    1024 + gb::RING_BYTES + BF16_STAGE_BYTES + gb::BAR_BYTES;

template <int KIND>
__global__ void __launch_bounds__(gb::NT, 2)
tile_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap ty,
                 const float* __restrict__ xsq, const float* __restrict__ ysq,
                 float* __restrict__ out, int M, int N, int D, Epilogue epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hop::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* stg_all =
      reinterpret_cast<float*>(smem_raw + (ring - raw) + gb::RING_BYTES);
  const uint32_t bars = ring + gb::RING_BYTES + (uint32_t)BF16_STAGE_BYTES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int tn = (N + gb::BN - 1) / gb::BN;
  const int tiles = (M + gb::BM - 1) / gb::BM * tn;
  const int ib = gf::range_begin(blockIdx.x, gridDim.x, tiles);
  const int ie = gf::range_begin(blockIdx.x + 1, gridDim.x, tiles);
  float* stg = stg_all + warp * 8 * BF16_SLD;
  gb::Ring<true> rg(ring, bars, &tx, &ty, D, tn, ib, ie);
  // acc[4 j + e]: row g + 8 (e >> 1), column 8 j + 2 t + (e & 1)
  float acc[gb::BN / 2];
  for (int u = ib; u < ie; ++u) {
    // the warp's first row: 64 a warpgroup, 16 a warp
    const int r0 = u / tn * gb::BM + 64 * (warp >> 2) + 16 * (warp & 3);
    const int c0 = u % tn * gb::BN;
    rg.product(acc, &tx, &ty);
    float xs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r0 + 8 * h + g;
      xs[h] = gr < M ? __ldg(xsq + gr) : 0.0f;
    }
    // 32 columns at a time (their |y|^2 loaded once), rows 8 h .. 8 h + 7
    // of the warp: epilogue, then through the buffer
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float ys[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gc = c0 + 8 * (4 * q + j) + 2 * t + e;
          ys[j][e] = gc < N ? __ldg(ysq + gc) : 0.0f;
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __syncwarp();   // the buffer's previous rows have left
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* a = acc + 4 * (4 * q + j) + 2 * h;
          *reinterpret_cast<float2*>(stg + g * BF16_SLD + 8 * j + 2 * t) =
              make_float2(mercer<KIND>(epi, a[0], xs[h], ys[j][0]),
                          mercer<KIND>(epi, a[1], xs[h], ys[j][1]));
        }
        __syncwarp();
        warp_store<8, 32>(stg, BF16_SLD, out, r0 + 8 * h, c0 + 32 * q, M, N);
      }
    }
  }
}

// ---- launchers -------------------------------------------------------------

// norms [M + N] f32 scratch for |x|^2 and |y|^2 (common.cuh
// launch_sqnorms: |x|^2 alone when y is x); ctas: the grid
// (kernels/kernel_matrix.py tile_ctas)
template <int KIND>
static int launch_f32(const float* x, const float* y, float* norms,
                      float* out, int M, int N, int D, int ctas,
                      const Epilogue& epi, cudaStream_t stream) {
  cudaError_t err = smem_once<tile_f32_kernel<KIND>>(F32_SMEM, true);
  if (err != cudaSuccess) return (int)err;
  const float* ysq = nullptr;
  if ((err = (cudaError_t)gf::launch_tf32_sqnorms(x, M, y, N, D, norms, &ysq,
                                                  stream)) != cudaSuccess)
    return (int)err;
  tile_f32_kernel<KIND><<<ctas, gf::NT, F32_SMEM, stream>>>(
      x, y, norms, ysq, out, M, N, D, epi);
  return (int)cudaGetLastError();
}

template <int KIND>
static int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                       float* norms, float* out, int M, int N, int D,
                       int ctas, const Epilogue& epi, cudaStream_t stream) {
  CUtensorMap tx, ty;
  if (!hop::encode_2d(&tx, x, M, D, D, gb::BM) ||
      !hop::encode_2d(&ty, y, N, D, D, gb::BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_once<tile_bf16_kernel<KIND>>(BF16_SMEM, true);
  if (err != cudaSuccess) return (int)err;
  const float* ysq = nullptr;
  if ((err = (cudaError_t)launch_sqnorms(x, M, y, N, D, norms, &ysq,
                                         stream)) != cudaSuccess)
    return (int)err;
  tile_bf16_kernel<KIND><<<ctas, gb::NT, BF16_SMEM, stream>>>(
      tx, ty, norms, ysq, out, M, N, D, epi);
  return (int)cudaGetLastError();
}

// one instantiation per Mercer kind
template <class T>
static int dispatch(const void* x, const void* y, void* norms, void* out,
                    int M, int N, int D, int ctas, int kind, float gamma,
                    float coef0, int degree, void* stream) {
  constexpr bool F32 = sizeof(T) == 4;
  if (M <= 0 || N <= 0 || D <= 0 || D % Vec16<T>::W != 0 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const Epilogue epi{kind, gamma, coef0, degree};
  const cudaStream_t s = (cudaStream_t)stream;
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(y);
  float* nt = static_cast<float*>(norms);
  float* ot = static_cast<float*>(out);
#define RT_TILE_CASE(K)                                                    \
  case K:                                                                  \
    if constexpr (F32)                                                     \
      return launch_f32<K>(reinterpret_cast<const float*>(xt),             \
                           reinterpret_cast<const float*>(yt), nt, ot, M,  \
                           N, D, ctas, epi, s);                            \
    else                                                                   \
      return launch_bf16<K>(reinterpret_cast<const __nv_bfloat16*>(xt),    \
                            reinterpret_cast<const __nv_bfloat16*>(yt),    \
                            nt, ot, M, N, D, ctas, epi, s);
  switch (kind) {
    RT_TILE_CASE(LINEAR)
    RT_TILE_CASE(POLYNOMIAL)
    RT_TILE_CASE(COSINE)
    RT_TILE_CASE(RBF)
  }
#undef RT_TILE_CASE
  return (int)cudaErrorInvalidValue;
}

// CTAs of kind's instantiation of the T body one SM holds
template <class T, int KIND>
static int ctas_per_sm_kind(int* out) {
  if constexpr (sizeof(T) == 4) {
    const cudaError_t err =
        smem_once<tile_f32_kernel<KIND>>(F32_SMEM, true);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, tile_f32_kernel<KIND>, gf::NT, F32_SMEM);
  } else {
    const cudaError_t err =
        smem_once<tile_bf16_kernel<KIND>>(BF16_SMEM, true);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        out, tile_bf16_kernel<KIND>, gb::NT, BF16_SMEM);
  }
}

template <class T>
static int ctas_per_sm(int kind, int* out) {
  switch (kind) {
    case LINEAR: return ctas_per_sm_kind<T, LINEAR>(out);
    case POLYNOMIAL: return ctas_per_sm_kind<T, POLYNOMIAL>(out);
    case COSINE: return ctas_per_sm_kind<T, COSINE>(out);
    case RBF: return ctas_per_sm_kind<T, RBF>(out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace tile

// ---- column body -----------------------------------------------------------

namespace col {

constexpr int NT = 256;
constexpr int NW = NT / 32;
// lanes that share a row: a whole warp for rows of at least 128 vectors
// of 16 bytes (D >= 512 f32 or 1024 bf16), so that a 15,000-row batch
// still gives every warp of the grid rows; eight lanes for narrower rows,
// whose sums then take 3 shuffles a value instead of 5 (the shuffles
// bounded rows of D = 128 on a whole warp)
constexpr int WIDE_ROW_VECTORS = 128;

// rows a lane group streams at once: more where few columns leave
// registers free
template <int NC>
__host__ __device__ constexpr int rows_per_group() {
  return NC <= 4 ? 8 : (NC <= 16 ? 4 : 2);
}

template <class T, int NC, int LPR>
__global__ void __launch_bounds__(NT, 2)
kernel_matrix_col_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                         float* __restrict__ out, int M, int N, int D,
                         Epilogue epi) {
  using V = Vec16<T>;
  constexpr int W = V::W, R = rows_per_group<NC>();
  extern __shared__ __align__(16) float ys[];   // [NC][D] f32, then |y|^2
  float* ysq = ys + NC * D;
  for (int i = threadIdx.x; i < NC * (D / W); i += NT) {
    const int n = i / (D / W), k = (i % (D / W)) * W;
    float v[W];
    if (n < N) {
      V::load(Y + (size_t)n * D + k, v);
    } else {
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = 0.0f;
    }
#pragma unroll
    for (int w = 0; w < W; w += 4)
      *reinterpret_cast<float4*>(ys + n * D + k + w) =
          make_float4(v[w], v[w + 1], v[w + 2], v[w + 3]);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int n = warp; n < NC; n += NW) {   // |y_n|^2 of the staged values
    float a = 0.0f;
    for (int k = lane; k < D; k += 32) a = fmaf(ys[n * D + k], ys[n * D + k], a);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
    if (lane == 0) ysq[n] = a;
  }
  __syncthreads();

  // a group of LPR lanes streams R rows; a warp takes GROUPS groups
  constexpr int GROUPS = 32 / LPR;
  const int sub = lane % LPR;
  const int passes = (M + R * GROUPS - 1) / (R * GROUPS);
  for (int q = blockIdx.x * NW + warp; q < passes; q += gridDim.x * NW) {
    const int r0 = (q * GROUPS + lane / LPR) * R;
    float acc[R][NC], sq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sq[r] = 0.0f;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[r][n] = 0.0f;
    }
    for (int k = sub * W; k < D; k += LPR * W) {
      float xv[R][W];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r0 + r < M) {
          V::load(X + (size_t)(r0 + r) * D + k, xv[r]);
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) xv[r][w] = 0.0f;
        }
#pragma unroll
        for (int w = 0; w < W; ++w) sq[r] = fmaf(xv[r][w], xv[r][w], sq[r]);
      }
#pragma unroll
      for (int n = 0; n < NC; ++n) {
#pragma unroll
        for (int w = 0; w < W; w += 4) {
          const float4 y = *reinterpret_cast<const float4*>(ys + n * D + k + w);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            acc[r][n] = fmaf(xv[r][w], y.x, acc[r][n]);
            acc[r][n] = fmaf(xv[r][w + 1], y.y, acc[r][n]);
            acc[r][n] = fmaf(xv[r][w + 2], y.z, acc[r][n]);
            acc[r][n] = fmaf(xv[r][w + 3], y.w, acc[r][n]);
          }
        }
      }
    }
    // sums over the group's lanes; then its lane (r NC + n) mod LPR stores
    // K[r0 + r, n]
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) {
        sq[r] += __shfl_xor_sync(0xffffffffu, sq[r], o);
#pragma unroll
        for (int n = 0; n < NC; ++n)
          acc[r][n] += __shfl_xor_sync(0xffffffffu, acc[r][n], o);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int n = 0; n < NC; ++n)
        if (sub == (r * NC + n) % LPR && n < N && r0 + r < M)
          out[(size_t)(r0 + r) * N + n] = epi(acc[r][n], sq[r], ysq[n]);
  }
}

// the most shared memory a block may use, and an SM holds
constexpr size_t SMEM_BLOCK = 232448, SMEM_SM = 233472;

// CTAs one SM holds: two by registers (__launch_bounds__(NT, 2)), fewer
// where Y's copy leaves shared memory for one (each block also reserves
// 1 KB)
__host__ __device__ constexpr int ctas_per_sm(size_t smem) {
  return smem > SMEM_BLOCK ? 0 : (2 * (smem + 1024) <= SMEM_SM ? 2 : 1);
}

template <class T, int NC, int LPR>
static int launch(const void* x, const void* y, void* out, int M, int N,
                  int D, const Epilogue& epi, cudaStream_t stream) {
  auto kernel = kernel_matrix_col_kernel<T, NC, LPR>;
  const size_t smem = sizeof(float) * NC * ((size_t)D + 1);
  const int per_sm = ctas_per_sm(smem);
  if (per_sm < 1) return (int)cudaErrorInvalidValue;   // Y does not fit
  cudaError_t err = smem_once<kernel_matrix_col_kernel<T, NC, LPR>>(
      SMEM_BLOCK, false);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  // rows a block takes per pass
  constexpr int ROWS = rows_per_group<NC>() * (32 / LPR) * NW;
  const int blocks = std::min((M + ROWS - 1) / ROWS, sms * per_sm);
  kernel<<<blocks, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<float*>(out), M, N, D, epi);
  return (int)cudaGetLastError();
}

template <class T, int NC>
static int launch_rows(const void* x, const void* y, void* out, int M,
                       int N, int D, const Epilogue& epi,
                       cudaStream_t stream) {
  if (D / Vec16<T>::W >= WIDE_ROW_VECTORS)
    return launch<T, NC, 32>(x, y, out, M, N, D, epi, stream);
  return launch<T, NC, 8>(x, y, out, M, N, D, epi, stream);
}

// the instantiation of the fewest columns >= N (kernels/kernel_matrix.py
// COL_WIDTHS)
template <class T>
static int dispatch(const void* x, const void* y, void* out, int M, int N,
                    int D, int kind, float gamma, float coef0, int degree,
                    void* stream) {
  if (M <= 0 || N <= 0 || D <= 0 || D % Vec16<T>::W != 0)
    return (int)cudaErrorInvalidValue;
  const Epilogue epi{kind, gamma, coef0, degree};
  const cudaStream_t s = (cudaStream_t)stream;
  if (N <= 1) return launch_rows<T, 1>(x, y, out, M, N, D, epi, s);
  if (N <= 4) return launch_rows<T, 4>(x, y, out, M, N, D, epi, s);
  if (N <= 8) return launch_rows<T, 8>(x, y, out, M, N, D, epi, s);
  if (N <= 16) return launch_rows<T, 16>(x, y, out, M, N, D, epi, s);
  if (N <= 32) return launch_rows<T, 32>(x, y, out, M, N, D, epi, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace col
}  // namespace rt

// the tile bodies: norms [M + N] f32 scratch for the row norms the launch
// computes; ctas: the persistent grid (kernels/kernel_matrix.py
// tile_ctas); D a multiple of 4 (f32) or 8 (bf16: 16-byte TMA strides)
extern "C" int rt_kernel_matrix_f32(const void* x, const void* y,
                                    void* norms, void* out, int M, int N,
                                    int D, int ctas, int kind, float gamma,
                                    float coef0, int degree, void* stream) {
  return rt::tile::dispatch<float>(x, y, norms, out, M, N, D, ctas, kind,
                                   gamma, coef0, degree, stream);
}

extern "C" int rt_kernel_matrix_bf16(const void* x, const void* y,
                                     void* norms, void* out, int M, int N,
                                     int D, int ctas, int kind, float gamma,
                                     float coef0, int degree, void* stream) {
  return rt::tile::dispatch<__nv_bfloat16>(x, y, norms, out, M, N, D, ctas,
                                           kind, gamma, coef0, degree,
                                           stream);
}

// *out = CTAs of the f32 (bf16) tile body, kind's instantiation, one SM of
// the current device holds
extern "C" int rt_kernel_matrix_f32_ctas_per_sm(int kind, int* out) {
  return rt::tile::ctas_per_sm<float>(kind, out);
}

extern "C" int rt_kernel_matrix_bf16_ctas_per_sm(int kind, int* out) {
  return rt::tile::ctas_per_sm<__nv_bfloat16>(kind, out);
}

// the column body: N <= 32; |x|^2 and |y|^2 come from the kernel's own
// loads of x and y
extern "C" int rt_kernel_matrix_col_f32(const void* x, const void* y,
                                        void* out, int M, int N, int D,
                                        int kind, float gamma, float coef0,
                                        int degree, void* stream) {
  return rt::col::dispatch<float>(x, y, out, M, N, D, kind, gamma, coef0,
                                  degree, stream);
}

extern "C" int rt_kernel_matrix_col_bf16(const void* x, const void* y,
                                         void* out, int M, int N, int D,
                                         int kind, float gamma, float coef0,
                                         int degree, void* stream) {
  return rt::col::dispatch<__nv_bfloat16>(x, y, out, M, N, D, kind, gamma,
                                          coef0, degree, stream);
}
