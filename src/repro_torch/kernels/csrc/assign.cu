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
// that is ~3,700 flops per byte, far above the ridge of either body on
// the tensor cores: f32-accurate work in 3xTF32 (165 TFLOP/s over 3.35
// TB/s: ~50 flops per byte) and bf16 (989 TFLOP/s: ~295 flops per byte).
//
// What the design does about it: two bodies behind one contract, both
// with the landmark axis split over a second grid dimension so that even
// |L| = 3,000 fills the card; a second small kernel (assign_f32.cuh
// assign_reduce_kernel) sums the splits in a fixed order and takes the
// argmin, so no atomics and the same bits from two launches.
//   f32 tiles (assign_f32.cuh): 3xTF32 mma.sync on the tensor cores for
//     both the Gram tile and the contraction against H, X and L chunks
//     streamed through a cp.async ring, two CTAs per SM.
//   bf16 tiles (assign_bf16.cuh): the Gram tiles on wgmma m64n128k16 from
//     a 3-stage TMA ring (128-byte swizzle, mbarriers), the contraction
//     against H in 3xTF32 mma.sync straight from the wgmma accumulators,
//     two CTAs of two warpgroups per SM so one CTA's epilogue runs beside
//     the other's products.
// The f accumulator [128, Cp] of a split stays in shared memory across its
// landmark tiles, so Cp <= 256; the wrapper (ops.py) launches once per 256
// clusters beyond that, for both bodies. The TPU GPU body held the whole
// landmark panel in one program; at L = 15000, D = 784 that cannot fit,
// which is why the landmark loop streams tiles instead.
#include "assign_bf16.cuh"
#include "assign_f32.cuh"

// norms [M + L] and part [splits, M, Cp] f32 scratch (part is f itself
// when splits == 1); splits from kernels/assign.py landmark_splits. The
// entry computes the row norms of x and l into norms (common.cuh
// row_sqnorms_kernel), then launches the body and the reduction.
extern "C" int rt_assign_fused_f32(const void* x, const void* l, void* norms,
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
      static_cast<float*>(norms), static_cast<const float*>(h),
      static_cast<const float*>(g), static_cast<int*>(labels),
      static_cast<float*>(mind), static_cast<float*>(f),
      static_cast<float*>(part), M, L, D, Cp, splits,
      Epilogue{kind, gamma, coef0, degree}, (cudaStream_t)stream);
}

// *out = CTAs of the f32 body (kind's instantiation) one SM of the current
// device holds at Cp clusters
extern "C" int rt_assign_f32_ctas_per_sm(int Cp, int kind, int* out) {
  using namespace rt;
  if (Cp <= 0 || Cp > MAX_CP) return (int)cudaErrorInvalidValue;
  return af::dispatch_ctas_per_sm(kind, Cp, static_cast<int*>(out));
}

// the bf16 body's counterparts of the two entries above; x and l are
// read through TMA maps (D a multiple of 8: 16-byte row strides)
extern "C" int rt_assign_fused_bf16(const void* x, const void* l, void* norms,
                                    const void* h, const void* g, void* labels,
                                    void* mind, void* f, void* part, int M,
                                    int L, int D, int Cp, int splits, int kind,
                                    float gamma, float coef0, int degree,
                                    void* stream) {
  using namespace rt;
  if (Cp <= 0 || Cp > MAX_CP || Cp % HCH != 0 || D % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return ab::dispatch(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(l), static_cast<float*>(norms),
      static_cast<const float*>(h), static_cast<const float*>(g),
      static_cast<int*>(labels), static_cast<float*>(mind),
      static_cast<float*>(f), static_cast<float*>(part), M, L, D, Cp, splits,
      Epilogue{kind, gamma, coef0, degree}, (cudaStream_t)stream);
}

extern "C" int rt_assign_bf16_ctas_per_sm(int Cp, int kind, int* out) {
  using namespace rt;
  if (Cp <= 0 || Cp > MAX_CP) return (int)cudaErrorInvalidValue;
  return ab::dispatch_ctas_per_sm(kind, Cp, static_cast<int*>(out));
}
