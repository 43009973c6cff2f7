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
// that is ~3,700 flops per byte, far above the f32 ridge of 20 flops/byte.
//
// What the design does about it. The TPU ran the landmark axis as a
// sequential grid dimension with the f accumulator in VMEM scratch; Hopper
// runs blocks in no order, so one CTA owns a block of BM = 128 rows and
// loops over all landmark tiles itself:
//   1. build the [128 x 128] Gram tile from D-chunks staged through shared
//      memory (gram_tile.cuh: f32 FMA or bf16 mma.sync), apply the epilogue
//      in registers, zero the columns past L;
//   2. park the tile in shared memory (aliasing the staging buffers, which
//      are idle by then) and contract it at once against H, 16 cluster
//      columns at a time, into the f accumulator [128 x Cp] that stays in
//      shared memory across the whole landmark loop;
//   3. after the last tile write f, then mind and the label of every row.
// Shared memory: 66,048 B (tile) + 8,192 B (H chunk) + 512*Cp B (f), so
// Cp <= 256 fits the 227 KB a block may use; the wrapper (ops.py) launches
// once per 256 clusters beyond that. The TPU GPU body held the
// whole landmark panel in one program; at L = 15000, D = 784 that cannot
// fit, which is why the landmark loop streams tiles instead.
#include "gram_tile.cuh"

namespace rt {

constexpr int HCH = 16;        // cluster columns of H per contraction chunk
constexpr int MAX_CP = 256;
constexpr int KS_LD = BN + 1;  // row stride of the parked Gram tile

// parked Gram tile; the staging buffers of either engine alias its start
constexpr size_t TILE_BYTES = sizeof(float) * BM * KS_LD;

static size_t assign_smem_bytes(int cp) {
  return TILE_BYTES + sizeof(float) * BN * HCH + sizeof(float) * BM * cp;
}

template <class Tile>
__global__ void __launch_bounds__(NTHREADS)
assign_fused_kernel(const typename Tile::T* __restrict__ X,
                    const typename Tile::T* __restrict__ Lm,
                    const float* __restrict__ xsq,
                    const float* __restrict__ lsq,
                    const float* __restrict__ H,
                    const float* __restrict__ g,
                    int* __restrict__ labels, float* __restrict__ mind,
                    float* __restrict__ F, int M, int L, int D, int Cp,
                    Epilogue epi) {
  static_assert(sizeof(typename Tile::Smem) <= TILE_BYTES,
                "staging buffers must fit in the parked-tile region");
  extern __shared__ __align__(16) unsigned char smem[];
  auto& stage = *reinterpret_cast<typename Tile::Smem*>(smem);
  float(*ks)[KS_LD] = reinterpret_cast<float(*)[KS_LD]>(smem);
  float* hs = reinterpret_cast<float*>(smem + TILE_BYTES);     // [BN][HCH]
  float* fs = hs + BN * HCH;                                    // [BM][Cp]

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BM;
  for (int i = tid; i < BM * Cp; i += NTHREADS) fs[i] = 0.0f;

  // contraction mapping: thread owns cluster column hc of the chunk and
  // rows hr + 16j — always the same f elements, so no two threads race.
  const int hc = tid & (HCH - 1), hr = tid >> 4;

  for (int l0 = 0; l0 < L; l0 += BN) {
    Tile tile;
    tile.compute(X, Lm, M, L, D, r0, l0, stage);   // ends on a barrier
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      int r, c;
      Tile::coord(e, r, c);
      const int gr = r0 + r, gl = l0 + c;
      float v = 0.0f;   // landmarks past L contribute nothing
      if (gr < M && gl < L) v = epi(tile.acc[e], __ldg(xsq + gr), __ldg(lsq + gl));
      ks[r][c] = v;
    }
    __syncthreads();

    for (int c0 = 0; c0 < Cp; c0 += HCH) {
      for (int i = tid; i < BN * HCH; i += NTHREADS) {
        const int l = i / HCH, j = i % HCH;
        hs[i] = (l0 + l < L) ? __ldg(H + (size_t)(l0 + l) * Cp + c0 + j) : 0.0f;
      }
      __syncthreads();
      float a[BM / 16];
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) a[j] = 0.0f;
#pragma unroll 8
      for (int l = 0; l < BN; ++l) {
        const float hv = hs[l * HCH + hc];
#pragma unroll
        for (int j = 0; j < BM / 16; ++j) a[j] = fmaf(ks[hr + 16 * j][l], hv, a[j]);
      }
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) fs[(hr + 16 * j) * Cp + c0 + hc] += a[j];
      __syncthreads();
    }
  }

  for (int i = tid; i < BM * Cp; i += NTHREADS) {
    const int r = i / Cp;
    if (r0 + r < M) F[(size_t)r0 * Cp + i] = fs[i];
  }
  if (tid < BM && r0 + tid < M) {
    // first strict minimum wins: the lowest cluster index on ties
    const float* fr = fs + tid * Cp;
    float best = __ldg(g) - 2.0f * fr[0];
    int arg = 0;
    for (int c = 1; c < Cp; ++c) {
      const float d = __ldg(g + c) - 2.0f * fr[c];
      if (d < best) { best = d; arg = c; }
    }
    labels[r0 + tid] = arg;
    mind[r0 + tid] = best;
  }
}

template <class Tile>
static int launch_assign(const void* x, const void* l, const void* xsq,
                         const void* lsq, const void* h, const void* g,
                         void* labels, void* mind, void* f, int M, int L,
                         int D, int Cp, int kind, float gamma, float coef0,
                         int degree, void* stream) {
  if (Cp <= 0 || Cp > MAX_CP || Cp % HCH != 0) return (int)cudaErrorInvalidValue;
  const size_t bytes = assign_smem_bytes(Cp);
  cudaError_t err = cudaFuncSetAttribute(
      assign_fused_kernel<Tile>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const Epilogue epi{kind, gamma, coef0, degree};
  assign_fused_kernel<Tile><<<(M + BM - 1) / BM, NTHREADS, bytes,
                              (cudaStream_t)stream>>>(
      static_cast<const typename Tile::T*>(x),
      static_cast<const typename Tile::T*>(l),
      static_cast<const float*>(xsq), static_cast<const float*>(lsq),
      static_cast<const float*>(h), static_cast<const float*>(g),
      static_cast<int*>(labels), static_cast<float*>(mind),
      static_cast<float*>(f), M, L, D, Cp, epi);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" int rt_assign_fused_f32(const void* x, const void* l,
                                   const void* xsq, const void* lsq,
                                   const void* h, const void* g, void* labels,
                                   void* mind, void* f, int M, int L, int D,
                                   int Cp, int kind, float gamma, float coef0,
                                   int degree, void* stream) {
  return rt::launch_assign<rt::TileF32>(x, l, xsq, lsq, h, g, labels, mind, f,
                                        M, L, D, Cp, kind, gamma, coef0,
                                        degree, stream);
}

extern "C" int rt_assign_fused_bf16(const void* x, const void* l,
                                    const void* xsq, const void* lsq,
                                    const void* h, const void* g, void* labels,
                                    void* mind, void* f, int M, int L, int D,
                                    int Cp, int kind, float gamma, float coef0,
                                    int degree, void* stream) {
  return rt::launch_assign<rt::TileBF16>(x, l, xsq, lsq, h, g, labels, mind,
                                         f, M, L, D, Cp, kind, gamma, coef0,
                                         degree, stream);
}
