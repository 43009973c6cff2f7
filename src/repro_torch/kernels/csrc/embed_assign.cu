// embed_assign: explicit feature map + contraction with the centroids +
// argmin, with the embedded rows never in device memory.
//
// Replaces the TPU kernel embed_assign_pallas
// (src/repro/kernels/embed_assign.py:111, bodies _kernel :48 and
// _kernel_gpu :88). For rows x [n, D] and a map panel w [M, D] it computes
//   E     = scale cos(x . w^T + b)        random Fourier features, or
//         = epilogue(x . w^T, |x|^2, |w|^2)  Nystrom (w = landmarks; the
//           whitening projection is folded into V by the wrapper)
//   F     = E . V                         [n, Cp]  V = centroids^T or
//                                                  proj . centroids^T
//   score = min_j (csq_j - 2 F_ij)         [n]     = |z - c_j|^2 - |z|^2
//   label = argmin_j (csq_j - 2 F_ij)      [n]     lowest index on ties
// csq carries +1e30 on empty and padded clusters. aux [M] is the phase b
// for RFF and the landmark squared norms for Nystrom; V's rows past M are
// never read and E's columns past M are zeroed, since an RFF column of a
// padded dimension would be scale cos(0) = scale, not 0.
//
// What bounds it on an H100: operations. At the Fig.5 setting (n = 60,000,
// D = 784, M = 320, C = 10) it does 2*n*M*(D + C) = 30.5 GFLOP against
// 188 MB of f32 rows: ~160 flops per byte, far above the f32 ridge of 20.
//
// What the design does about it: two engines behind one contract.
//   f32 tiles (embed_f32.cuh): f32 FMA on the CUDA cores at two CTAs of
//     256 threads per SM (at most 128 registers a thread), X and W chunks
//     streamed through a cp.async ring with one barrier per chunk, a
//     column tile of 160, 80, 40 or 20 that follows M (the launcher's
//     choice, kernels/embed_assign.py), any C up to 256 unpadded.
//   bf16 tiles: assign_fused with another epilogue. One CTA owns 128 rows
//     and loops over the embed tiles of w (row_block.cuh): each [128 x 128]
//     tile of x . w^T comes from gram_tile.cuh (bf16 mma.sync).
// Both apply the RFF epilogue (RffEpilogue, full-range cosf) or the Mercer
// Epilogue on chip, contract each tile at once against V into the on-chip
// F [rows x C], and take the argmin after the last tile.
#include "embed_f32.cuh"

namespace rt {

template <class Epi>
__global__ void __launch_bounds__(NTHREADS)
embed_assign_kernel(const TileBF16::T* __restrict__ X,
                    const TileBF16::T* __restrict__ W,
                    const float* __restrict__ xsq,
                    const float* __restrict__ aux,
                    const float* __restrict__ V,
                    const float* __restrict__ csq,
                    int* __restrict__ labels, float* __restrict__ score,
                    int n, int M, int D, int Cp, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.x * BM;
  const float* fs = row_block_contract(X, W, xsq, aux, V, n, M, D, Cp, epi,
                                       r0, smem);
  row_block_argmin<BM>(fs, csq, Cp, r0, n, labels, score);
}

template <class Epi>
static int launch_embed_assign(const void* x, const void* w, const void* xsq,
                               const void* aux, const void* v,
                               const void* csq, void* labels, void* score,
                               int n, int M, int D, int Cp, Epi epi,
                               void* stream) {
  const size_t bytes = row_block_smem_bytes(Cp);
  const cudaError_t err =
      smem_once<embed_assign_kernel<Epi>>(row_block_smem_bytes(MAX_CP),
                                          false);
  if (err != cudaSuccess) return (int)err;
  embed_assign_kernel<Epi><<<(n + BM - 1) / BM, NTHREADS, bytes,
                             (cudaStream_t)stream>>>(
      static_cast<const TileBF16::T*>(x), static_cast<const TileBF16::T*>(w),
      static_cast<const float*>(xsq), static_cast<const float*>(aux),
      static_cast<const float*>(v), static_cast<const float*>(csq),
      static_cast<int*>(labels), static_cast<float*>(score), n, M, D, Cp,
      epi);
  return (int)cudaGetLastError();
}

// kind RFF takes the RffEpilogue, every other kind the Mercer Epilogue
static int embed_assign_bf16(const void* x, const void* w, const void* xsq,
                             const void* aux, const void* v, const void* csq,
                             void* labels, void* score, int n, int M, int D,
                             int Cp, int kind, float gamma, float coef0,
                             int degree, float scale, void* stream) {
  if (Cp <= 0 || Cp > MAX_CP || Cp % HCH != 0) return (int)cudaErrorInvalidValue;
  if (kind == RFF)
    return launch_embed_assign(x, w, xsq, aux, v, csq, labels, score, n, M,
                               D, Cp, RffEpilogue{scale}, stream);
  return launch_embed_assign(x, w, xsq, aux, v, csq, labels, score, n, M, D,
                             Cp, Epilogue{kind, gamma, coef0, degree},
                             stream);
}

}  // namespace rt

// v [M, C] and csq [C] for any C up to MAX_CP (no padding); bn, bm: the
// column tile and the row block, from the launcher
extern "C" int rt_embed_assign_f32(const void* x, const void* w,
                                   const void* xsq, const void* aux,
                                   const void* v, const void* csq,
                                   void* labels, void* score, int n, int M,
                                   int D, int C, int kind, float gamma,
                                   float coef0, int degree, float scale,
                                   int bn, int bm, void* stream) {
  using namespace rt;
  if (C <= 0 || C > MAX_CP) return (int)cudaErrorInvalidValue;
  if (kind == RFF)
    return ef::dispatch(bn, bm, x, w, xsq, aux, v, csq, labels, score, n, M,
                        D, C, RffEpilogue{scale}, stream);
  return ef::dispatch(bn, bm, x, w, xsq, aux, v, csq, labels, score, n, M, D,
                      C, Epilogue{kind, gamma, coef0, degree}, stream);
}

extern "C" int rt_embed_assign_bf16(const void* x, const void* w,
                                    const void* xsq, const void* aux,
                                    const void* v, const void* csq,
                                    void* labels, void* score, int n, int M,
                                    int D, int Cp, int kind, float gamma,
                                    float coef0, int degree, float scale,
                                    void* stream) {
  return rt::embed_assign_bf16(x, w, xsq, aux, v, csq, labels, score, n, M,
                               D, Cp, kind, gamma, coef0, degree, scale,
                               stream);
}
