// assign_fused: Gram tile + contraction with the label one-hot + argmin.
//
// Replaces the TPU kernel assign_fused_pallas
// (src/repro/kernels/assign.py:146, bodies _kernel :55 and _kernel_gpu
// :126). For rows x [M, D] and landmarks l [L, D] it computes
//   f     = epilogue(x . l^T) . H          [M, Cp]   (Eq.17)
//   mind  = min_j (g_j - 2 f_ij)           [M]       (Eq.15)
//   label = argmin_j (g_j - 2 f_ij)        [M]       lowest index on ties
// without ever writing the [M, L] Gram block to device memory. H [L, Cp] is
// one-hot(labels)/counts with zero columns for padded clusters; g [Cp]
// carries +1e30 on empty and padded clusters. With g = 0 the same kernel is
// the Gram-free matvec K . H (ops.gram_matvec).
//
// What bounds it on an H100: operations. Per call it does 2*M*L*D flops
// for the Gram tiles (+2*M*L*Cp for the contraction) while moving only
// (M+L)*D operand elements and O(M*Cp) results: at M = L = 15000, D = 784
// that is ~3,700 flops per byte, far above the ridge of f32-accurate work
// on the tensor cores (3xTF32, 165 TFLOP/s over 3.35 TB/s: ~50 flops per
// byte).
//
// What the design does about it: two bodies behind one contract.
//   f32 tiles (assign_f32.cuh): 3xTF32 mma.sync on the tensor cores for
//     both the Gram tile and the contraction against H, the landmark axis
//     split over a second grid dimension so that even |L| = 3,000 fills
//     the card, X and L chunks streamed through a cp.async ring, two CTAs
//     per SM; a second small kernel sums the splits in a fixed order and
//     takes the argmin.
//   bf16 tiles: one CTA owns a block of BM = 128 rows and loops over all
//     landmark tiles itself:
//   1. build each [128 x 128] Gram tile on chip (gram_tile.cuh, bf16
//      mma.sync), apply the epilogue in registers and zero the columns
//      past L;
//   2. contract it at once against H into the f accumulator [128 x Cp]
//      that stays in shared memory across the whole landmark loop
//      (row_block.cuh, shared with embed_assign.cu);
//   3. after the last tile write f, then mind and the label of every row.
// Shared memory of the bf16 body: 66,048 B (tile) + 8,192 B (H chunk) +
// 512*Cp B (f), so Cp <= 256 fits the 227 KB a block may use; the wrapper
// (ops.py) launches once per 256 clusters beyond that, for both bodies.
// The TPU GPU body held the whole landmark panel in one program; at L =
// 15000, D = 784 that cannot fit, which is why the landmark loop streams
// tiles instead.
#include "assign_f32.cuh"
#include "row_block.cuh"

namespace rt {

__global__ void __launch_bounds__(NTHREADS)
assign_fused_kernel(const TileBF16::T* __restrict__ X,
                    const TileBF16::T* __restrict__ Lm,
                    const float* __restrict__ xsq,
                    const float* __restrict__ lsq,
                    const float* __restrict__ H,
                    const float* __restrict__ g,
                    int* __restrict__ labels, float* __restrict__ mind,
                    float* __restrict__ F, int M, int L, int D, int Cp,
                    Epilogue epi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.x * BM;
  const float* fs = row_block_contract(X, Lm, xsq, lsq, H, M, L, D, Cp, epi,
                                       r0, smem);
  for (int i = threadIdx.x; i < BM * Cp; i += NTHREADS) {
    const int r = i / Cp;
    if (r0 + r < M) F[(size_t)r0 * Cp + i] = fs[i];
  }
  row_block_argmin<BM>(fs, g, Cp, r0, M, labels, mind);
}

static int launch_assign_bf16(const void* x, const void* l, const void* xsq,
                              const void* lsq, const void* h, const void* g,
                              void* labels, void* mind, void* f, int M, int L,
                              int D, int Cp, int kind, float gamma,
                              float coef0, int degree, void* stream) {
  if (Cp <= 0 || Cp > MAX_CP || Cp % HCH != 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = row_block_smem_bytes(Cp);
  const cudaError_t err =
      smem_once<assign_fused_kernel>(row_block_smem_bytes(MAX_CP), false);
  if (err != cudaSuccess) return (int)err;
  const Epilogue epi{kind, gamma, coef0, degree};
  assign_fused_kernel<<<(M + BM - 1) / BM, NTHREADS, bytes,
                        (cudaStream_t)stream>>>(
      static_cast<const TileBF16::T*>(x), static_cast<const TileBF16::T*>(l),
      static_cast<const float*>(xsq), static_cast<const float*>(lsq),
      static_cast<const float*>(h), static_cast<const float*>(g),
      static_cast<int*>(labels), static_cast<float*>(mind),
      static_cast<float*>(f), M, L, D, Cp, epi);
  return (int)cudaGetLastError();
}

}  // namespace rt

// part [splits, M, Cp] f32 scratch (f itself when splits == 1); splits
// from kernels/assign.py landmark_splits
extern "C" int rt_assign_fused_f32(const void* x, const void* l,
                                   const void* xsq, const void* lsq,
                                   const void* h, const void* g, void* labels,
                                   void* mind, void* f, void* part, int M,
                                   int L, int D, int Cp, int splits, int kind,
                                   float gamma, float coef0, int degree,
                                   void* stream) {
  using namespace rt;
  if (Cp <= 0 || Cp > MAX_CP || Cp % HCH != 0 || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return af::dispatch(
      static_cast<const float*>(x), static_cast<const float*>(l),
      static_cast<const float*>(xsq), static_cast<const float*>(lsq),
      static_cast<const float*>(h), static_cast<const float*>(g),
      static_cast<int*>(labels), static_cast<float*>(mind),
      static_cast<float*>(f), static_cast<float*>(part), M, L, D, Cp, splits,
      Epilogue{kind, gamma, coef0, degree}, (cudaStream_t)stream);
}

// *out = CTAs of the f32 body (kind's instantiation) one SM of the current
// device holds at Cp clusters
extern "C" int rt_assign_f32_ctas_per_sm(int Cp, int kind, int* out) {
  using namespace rt;
  if (Cp <= 0 || Cp > MAX_CP) return (int)cudaErrorInvalidValue;
  return af::dispatch_ctas_per_sm(kind, Cp, static_cast<int*>(out));
}

extern "C" int rt_assign_fused_bf16(const void* x, const void* l,
                                    const void* xsq, const void* lsq,
                                    const void* h, const void* g, void* labels,
                                    void* mind, void* f, int M, int L, int D,
                                    int Cp, int kind, float gamma, float coef0,
                                    int degree, void* stream) {
  return rt::launch_assign_bf16(x, l, xsq, lsq, h, g, labels, mind, f, M, L,
                                D, Cp, kind, gamma, coef0, degree, stream);
}
