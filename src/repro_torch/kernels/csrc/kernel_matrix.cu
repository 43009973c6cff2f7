// kernel_matrix: K(X, Y) = epilogue(X . Y^T) -> [M, N] f32.
//
// Replaces the TPU kernel kernel_matrix_pallas
// (src/repro/kernels/kernel_matrix.py:78, bodies _kernel :45 and the
// epilogue _epilogue :31-42): the same tiled Gram block with f32
// accumulation and an in-register epilogue for rbf, polynomial, cosine or
// linear, computed from the row squared norms xsq [M] and ysq [N].
//
// What bounds it on an H100 depends on N, so there are two bodies:
//   tile body (N > NCOL_MAX of kernels/kernel_matrix.py): operations. One
//     [M, N] block costs 2*M*N*D flops against (M+N)*D operand reads and
//     M*N f32 writes; at the Gram build's [15000 x 3000 x 784] that is ~220
//     flops per byte moved, far above the card's f32 ridge (67 TFLOP/s over
//     3.35 TB/s = 20 flops/byte). At f32 it is the CUDA cores' FMA rate; at
//     bf16 the tensor cores' mma rate. One CTA per [128 x 128] output tile,
//     register-blocked 8 x 8 per thread at f32 (64 FMAs per 4 vector shared
//     loads) or 4 x 4 mma.sync tiles per warp at bf16, with the next D-chunk
//     loaded into registers while the current one is multiplied
//     (gram_tile.cuh); xsq and ysq come from the wrapper. The epilogue runs
//     on the accumulators before the single store, so K is written once.
//   column body (N <= NCOL_MAX: the k-means++ columns [M, 1..5] and the
//     Eq.8 / predict blocks [M, 10]): bytes. 2*N flops per element of X
//     against the 4 (f32) or 2 (bf16) bytes of reading it, far below the
//     ridge, so the least time is X read once: 14 us for 15000 x 784 f32.
//     A tile of 128 columns would do 128/N times the work and the wrapper's
//     norm pass would read X a second time. Instead each CTA stages Y [N,
//     D] in shared memory once (as f32, columns past N zero) and sums |y|^2
//     there, and each group of LPR lanes (a warp for wide rows, 8 for
//     narrow ones) streams R rows of X at a time with 16-byte loads, lane
//     l of the group holding features 4l (f32) or 8l (bf16) of every 4 LPR
//     or 8 LPR; it accumulates the N dot products and |x|^2 of its rows in
//     f32 from the same loaded values (bf16 lifted to f32 first, as the
//     reference accumulates), sums them over the group's lanes with
//     shuffles, and stores N values a row after the epilogue. The wrapper computes no
//     norms on this route. The grid is sized to the CTAs the card holds at
//     once, each walking over row groups, so Y is staged once per CTA.
#include <algorithm>

#include "common.cuh"
#include "gram_tile.cuh"

namespace rt {

template <class Tile>
__global__ void __launch_bounds__(NTHREADS)
kernel_matrix_kernel(const typename Tile::T* __restrict__ X,
                     const typename Tile::T* __restrict__ Y,
                     const float* __restrict__ xsq,
                     const float* __restrict__ ysq,
                     float* __restrict__ out, int M, int N, int D,
                     Epilogue epi) {
  __shared__ typename Tile::Smem smem;
  const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
  Tile tile;
  tile.compute(X, Y, M, N, D, r0, c0, smem);
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    int r, c;
    Tile::coord(e, r, c);
    const int gr = r0 + r, gc = c0 + c;
    if (gr < M && gc < N)
      out[(size_t)gr * N + gc] = epi(tile.acc[e], __ldg(xsq + gr), __ldg(ysq + gc));
  }
}

template <class Tile>
static int launch_kernel_matrix(const void* x, const void* y, const void* xsq,
                                const void* ysq, void* out, int M, int N,
                                int D, int kind, float gamma, float coef0,
                                int degree, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  const Epilogue epi{kind, gamma, coef0, degree};
  kernel_matrix_kernel<Tile><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const typename Tile::T*>(x),
      static_cast<const typename Tile::T*>(y),
      static_cast<const float*>(xsq), static_cast<const float*>(ysq),
      static_cast<float*>(out), M, N, D, epi);
  return (int)cudaGetLastError();
}

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

extern "C" int rt_kernel_matrix_f32(const void* x, const void* y,
                                    const void* xsq, const void* ysq,
                                    void* out, int M, int N, int D, int kind,
                                    float gamma, float coef0, int degree,
                                    void* stream) {
  return rt::launch_kernel_matrix<rt::TileF32>(x, y, xsq, ysq, out, M, N, D,
                                               kind, gamma, coef0, degree,
                                               stream);
}

extern "C" int rt_kernel_matrix_bf16(const void* x, const void* y,
                                     const void* xsq, const void* ysq,
                                     void* out, int M, int N, int D, int kind,
                                     float gamma, float coef0, int degree,
                                     void* stream) {
  return rt::launch_kernel_matrix<rt::TileBF16>(x, y, xsq, ysq, out, M, N, D,
                                                kind, gamma, coef0, degree,
                                                stream);
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
