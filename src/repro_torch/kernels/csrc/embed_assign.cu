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
// csq carries +1e30 on empty and padded clusters. b [M] is RFF's phase;
// the Mercer kinds sum |x|^2 and |w|^2 in the launch (common.cuh
// launch_sqnorms, into a scratch of n + M the wrapper hands over). V's
// rows past M are never read and E's columns past M are zeroed, since an
// RFF column of a padded dimension would be scale cos(b), not 0.
//
// What bounds it on an H100: operations. At the Fig.5 setting (n = 60,000,
// D = 784, M = 320, C = 10) it does 2*n*M*D = 30 GFLOP of products (and
// 2*n*M*C = 0.4 GFLOP of contraction) against 188 MB of f32 rows or 94 MB
// of bf16 ones: ~320 flops per bf16 byte, above the bf16 ridge of 295, and
// ~160 per f32 byte, far above the f32 ridge of 20.
//
// What the design does about it: two bodies behind one contract.
//   f32 tiles (embed_f32.cuh): f32 FMA on the CUDA cores at two CTAs of
//     256 threads per SM (at most 128 registers a thread), X and W chunks
//     streamed through a cp.async ring with one barrier per chunk, a
//     column tile of 160, 80, 40 or 20 that follows M (the launcher's
//     choice, kernels/embed_assign.py), any C up to 256 unpadded; the
//     epilogue and the contraction on the CUDA cores, the argmin in the
//     kernel.
//   bf16 tiles (embed_bf16_kernel below): the assign_fused bf16 body
//     (assign_bf16.cuh ab::body) with the map as its epilogue. The tiles
//     of x . w^T come from wgmma m64n128k16 out of gram_bf16.cuh's 3-stage
//     TMA ring (128-byte swizzle), two warpgroups of 64 rows a CTA, two
//     CTAs per SM at 128 registers, so one CTA's epilogue and contraction
//     run while the other's products hold the tensor cores. The epilogue
//     (RFF or a Mercer kind, one instantiation each) runs on the
//     accumulators in registers, and each warp contracts them against V
//     in 3xTF32 mma.sync straight from the C-fragments. The w axis splits
//     over the grid as assign's landmark axis (kernels/assign.py
//     landmark_splits); af::assign_reduce_kernel sums the splits in a
//     fixed order and takes the argmin against csq, so two launches give
//     the same bits. One split (M = 320: 469 CTAs at n = 60,000) takes the
//     argmin in the kernel instead, by the same arithmetic: the reduce
//     launch (60,000 rows of 16 columns, a warp each) added 0.014-0.018
//     ms of the card a call there, and its F [n, Cp] was written only to
//     be read back (launch/kernel_ab.py on an H100).
//     At M = 320 a sixth of the products fall on padded columns (three
//     tiles of 128 for 320); the contraction skips them.
// Both apply the RFF epilogue (RffEpilogue: a full-range cosine, reduced
// by Cody-Waite, never __cosf) or the Mercer Epilogue on chip, and neither
// writes E to device memory.
#include "assign_bf16.cuh"
#include "embed_f32.cuh"

namespace rt {

// the bf16 body: V is H, csq is g, b is lsq for RFF; with labels (one
// split) it takes the argmin itself
template <int KIND>
__global__ void __launch_bounds__(ab::NT, 2)
embed_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const float* __restrict__ xsq,
                  const float* __restrict__ aux,
                  const float* __restrict__ V, float* __restrict__ part,
                  const float* __restrict__ csq, int* __restrict__ labels,
                  float* __restrict__ score, int n, int M, int D, int Cp,
                  ab::EpiOf<KIND> epi) {
  ab::body<KIND>(&tx, &tw, xsq, aux, V, part, csq, labels, score, n, M, D,
                 Cp, epi);
}

// one instantiation per epilogue; part [splits, n, Cp] f32 scratch, which
// the reduction also takes as its F (unused with one split)
static int embed_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                      const float* b, float* norms, const float* v,
                      const float* csq, int* labels, float* score,
                      float* part, int n, int M, int D, int Cp, int splits,
                      int kind, float gamma, float coef0, int degree,
                      float scale, cudaStream_t stream) {
  if (kind == RFF)
    return ab::launch_body<RFF, embed_bf16_kernel<RFF>, true>(
        x, w, nullptr, b, v, csq, labels, score, part, part, n, M, D, Cp,
        splits, RffEpilogue{scale}, stream);
  const Epilogue epi{kind, gamma, coef0, degree};
#define RT_EB_CASE(K)                                                     \
  case K:                                                                 \
    return ab::launch_body<K, embed_bf16_kernel<K>, true>(                \
        x, w, norms, nullptr, v, csq, labels, score, part, part, n, M, D, \
        Cp, splits, epi, stream);
  switch (kind) {
    RT_EB_CASE(LINEAR)
    RT_EB_CASE(POLYNOMIAL)
    RT_EB_CASE(COSINE)
    RT_EB_CASE(RBF)
  }
#undef RT_EB_CASE
  return (int)cudaErrorInvalidValue;
}

static int embed_bf16_ctas_per_sm(int kind, int Cp, int* out) {
  switch (kind) {
    case LINEAR: return ab::ctas_per_sm<embed_bf16_kernel<LINEAR>>(Cp, out);
    case POLYNOMIAL:
      return ab::ctas_per_sm<embed_bf16_kernel<POLYNOMIAL>>(Cp, out);
    case COSINE: return ab::ctas_per_sm<embed_bf16_kernel<COSINE>>(Cp, out);
    case RBF: return ab::ctas_per_sm<embed_bf16_kernel<RBF>>(Cp, out);
    case RFF: return ab::ctas_per_sm<embed_bf16_kernel<RFF>>(Cp, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt

// b [M] the phases (RFF; null otherwise), norms [n + M] f32 scratch (the
// Mercer kinds; null for RFF); v [M, C] and csq [C] for any C up to MAX_CP
// (no padding); bn, bm: the column tile and the row block, from the
// launcher
extern "C" int rt_embed_assign_f32(const void* x, const void* w,
                                   const void* b, void* norms, const void* v,
                                   const void* csq, void* labels, void* score,
                                   int n, int M, int D, int C, int kind,
                                   float gamma, float coef0, int degree,
                                   float scale, int bn, int bm,
                                   void* stream) {
  using namespace rt;
  if (C <= 0 || C > MAX_CP || n <= 0 || M <= 0 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (kind == RFF)
    return ef::dispatch(bn, bm, x, w, nullptr, b, v, csq, labels, score, n,
                        M, D, C, RffEpilogue{scale}, stream);
  const float* wsq = nullptr;
  const int err = launch_sqnorms(
      static_cast<const float*>(x), n, static_cast<const float*>(w), M, D,
      static_cast<float*>(norms), &wsq, (cudaStream_t)stream);
  if (err != 0) return err;
  return ef::dispatch(bn, bm, x, w, norms, wsq, v, csq, labels, score, n, M,
                      D, C, Epilogue{kind, gamma, coef0, degree}, stream);
}

// the bf16 body: v [M, Cp] and csq [Cp] with Cp a multiple of HCH, part
// [splits, n, Cp] f32 scratch, splits from kernels/assign.py
// landmark_splits; x and w are read through TMA maps (D a multiple of 8:
// 16-byte row strides)
extern "C" int rt_embed_assign_bf16(const void* x, const void* w,
                                    const void* b, void* norms, const void* v,
                                    const void* csq, void* labels, void* score,
                                    void* part, int n, int M, int D, int Cp,
                                    int splits, int kind, float gamma,
                                    float coef0, int degree, float scale,
                                    void* stream) {
  using namespace rt;
  if (Cp <= 0 || Cp > MAX_CP || Cp % HCH != 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return embed_bf16(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
      static_cast<float*>(norms), static_cast<const float*>(v),
      static_cast<const float*>(csq), static_cast<int*>(labels),
      static_cast<float*>(score), static_cast<float*>(part), n, M, D, Cp,
      splits, kind, gamma, coef0, degree, scale, (cudaStream_t)stream);
}

// *out = CTAs of the bf16 body (kind's instantiation, RFF = 4 included)
// one SM of the current device holds at Cp clusters
extern "C" int rt_embed_bf16_ctas_per_sm(int Cp, int kind, int* out) {
  using namespace rt;
  if (Cp <= 0 || Cp > MAX_CP) return (int)cudaErrorInvalidValue;
  return embed_bf16_ctas_per_sm(kind, Cp, static_cast<int*>(out));
}
