// The row-block contraction of the bf16 body of embed_assign.cu (and the
// row argmin sketch_assign.cu takes too).
//
// One CTA owns the BM = 128 rows from r0 and loops over all column tiles of
// Y ([N, D]: landmarks, RFF frequencies or Nystrom landmarks):
//   1. build the [128 x 128] tile X . Y^T from D-chunks staged through shared
//      memory (gram_tile.cuh: bf16 mma.sync), apply the epilogue
//      in registers, and zero the columns past N — an epilogue need not be 0
//      on a padded column (rbf: exp(-gamma |x|^2), RFF: scale cos(b)), so
//      zero rows of the panel alone would not keep padding out;
//   2. park the tile in shared memory (aliasing the staging buffers, which
//      are idle by then) and contract it at once against the panel P [N, Cp]
//      (V of the embedded assignment), 16 cluster
//      columns at a time, into the accumulator fs [128 x Cp] that stays in
//      shared memory across the whole column loop.
// row_block_argmin then takes min_j (g_j - 2 fs_ij) and its first (lowest)
// index for each row.
//
// Shared memory: 66,048 B (tile) + 8,192 B (panel chunk) + 512*Cp B (fs),
// so Cp <= 256 fits the 227 KB a block may use; the wrappers (ops.py)
// launch once per 256 clusters beyond that.
#pragma once

#include "gram_tile.cuh"

namespace rt {

constexpr int HCH = 16;        // cluster columns of P per contraction chunk
constexpr int MAX_CP = 256;
constexpr int KS_LD = BN + 1;  // row stride of the parked tile

// parked tile; the staging buffers of TileBF16 alias its start
constexpr size_t TILE_BYTES = sizeof(float) * BM * KS_LD;

inline size_t row_block_smem_bytes(int cp) {
  return TILE_BYTES + sizeof(float) * BN * HCH + sizeof(float) * BM * cp;
}

// fs [BM][Cp] = sum over column tiles of epi(X . Y^T)[r0:r0+BM, :] . P for
// the rows from r0 (epi an Epilogue or an RffEpilogue); returns fs (in
// smem), complete after a final barrier.
template <class Epi>
__device__ __forceinline__ float* row_block_contract(
    const TileBF16::T* __restrict__ X,
    const TileBF16::T* __restrict__ Y, const float* __restrict__ xsq,
    const float* __restrict__ ysq, const float* __restrict__ P, int M, int N,
    int D, int Cp, const Epi& epi, int r0, unsigned char* smem) {
  static_assert(sizeof(TileBF16::Smem) <= TILE_BYTES,
                "staging buffers must fit in the parked-tile region");
  auto& stage = *reinterpret_cast<TileBF16::Smem*>(smem);
  float(*ks)[KS_LD] = reinterpret_cast<float(*)[KS_LD]>(smem);
  float* ps = reinterpret_cast<float*>(smem + TILE_BYTES);     // [BN][HCH]
  float* fs = ps + BN * HCH;                                    // [BM][Cp]

  const int tid = threadIdx.x;
  for (int i = tid; i < BM * Cp; i += NTHREADS) fs[i] = 0.0f;

  // contraction mapping: thread owns cluster column hc of the chunk and
  // rows hr + 16j — always the same fs elements, so no two threads race.
  const int hc = tid & (HCH - 1), hr = tid >> 4;

  for (int c0 = 0; c0 < N; c0 += BN) {
    TileBF16 tile;
    tile.compute(X, Y, M, N, D, r0, c0, stage);   // ends on a barrier
#pragma unroll
    for (int e = 0; e < NACC; ++e) {
      int r, c;
      TileBF16::coord(e, r, c);
      const int gr = r0 + r, gc = c0 + c;
      float v = 0.0f;   // columns past N contribute nothing
      if (gr < M && gc < N) v = epi(tile.acc[e], __ldg(xsq + gr), __ldg(ysq + gc));
      ks[r][c] = v;
    }
    __syncthreads();

    for (int p0 = 0; p0 < Cp; p0 += HCH) {
      for (int i = tid; i < BN * HCH; i += NTHREADS) {
        const int l = i / HCH, j = i % HCH;
        ps[i] = (c0 + l < N) ? __ldg(P + (size_t)(c0 + l) * Cp + p0 + j) : 0.0f;
      }
      __syncthreads();
      float a[BM / 16];
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) a[j] = 0.0f;
#pragma unroll 8
      for (int l = 0; l < BN; ++l) {
        const float pv = ps[l * HCH + hc];
#pragma unroll
        for (int j = 0; j < BM / 16; ++j) a[j] = fmaf(ks[hr + 16 * j][l], pv, a[j]);
      }
#pragma unroll
      for (int j = 0; j < BM / 16; ++j) fs[(hr + 16 * j) * Cp + p0 + hc] += a[j];
      __syncthreads();
    }
  }
  return fs;
}

// For rows r0 .. r0+ROWS-1 (< M): labels = argmin_j (g_j - 2 fs_rj), the
// first strict minimum, i.e. the lowest cluster index on ties; best = min.
template <int ROWS>
__device__ __forceinline__ void row_block_argmin(const float* fs,
                                                 const float* __restrict__ g,
                                                 int Cp, int r0, int M,
                                                 int* __restrict__ labels,
                                                 float* __restrict__ best) {
  const int tid = threadIdx.x;
  if (tid < ROWS && r0 + tid < M) {
    const float* fr = fs + tid * Cp;
    float b = __ldg(g) - 2.0f * fr[0];
    int arg = 0;
    for (int c = 1; c < Cp; ++c) {
      const float d = __ldg(g + c) - 2.0f * fr[c];
      if (d < b) { b = d; arg = c; }
    }
    labels[r0 + tid] = arg;
    best[r0 + tid] = b;
  }
}

}  // namespace rt
