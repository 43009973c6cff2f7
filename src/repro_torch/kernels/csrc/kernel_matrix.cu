// kernel_matrix: K(X, Y) = epilogue(X . Y^T) -> [M, N] f32.
//
// Replaces the TPU kernel kernel_matrix_pallas
// (src/repro/kernels/kernel_matrix.py:78, bodies _kernel :45 and the
// epilogue _epilogue :31-42): the same tiled Gram block with f32
// accumulation and an in-register epilogue for rbf, polynomial, cosine or
// linear, computed from the row squared norms xsq [M] and ysq [N].
//
// What bounds it on an H100: operations. One [M, N] block costs 2*M*N*D
// flops against (M+N)*D operand reads and M*N f32 writes; at the main
// path's [15000 x 3000 x 784] that is ~220 flops per byte moved, far above
// the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20 flops/byte). At f32
// it is the CUDA cores' FMA rate; at bf16 the tensor cores' mma rate.
//
// What the design does about it: one CTA per [128 x 128] output tile,
// register-blocked 8 x 8 per thread at f32 (64 FMAs per 4 vector shared
// loads) or 4 x 4 mma.sync tiles per warp at bf16, with the next D-chunk
// loaded into registers while the current one is multiplied
// (gram_tile.cuh). The epilogue runs on the accumulators before the single
// store, so K is written once and never read back.
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
