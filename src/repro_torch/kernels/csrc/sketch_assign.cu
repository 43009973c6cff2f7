// sketch_assign: count-sketch + contraction with the centroids + argmin,
// with the sketched rows never in device memory.
//
// Replaces the TPU kernel sketch_assign_pallas
// (src/repro/kernels/sketch_assign.py:111, bodies _kernel :50 and
// _kernel_gpu :92). For rows x [n, D], a bucket hash h [D] (-1: lands
// nowhere) and signs s [D] it computes
//   z_j   = sum_{i: h_i = j} s_i x_i       [n, M]
//   score = min_j (csq_j - 2 (z . V)_ij)    [n]   V = centroids^T [M, Cp]
//   label = argmin_j (csq_j - 2 (z . V)_ij) [n]   lowest index on ties
// with csq at +1e30 on empty and padded clusters.
//
// The TPU has no cross-lane scatter, so its body built a masked one-hot
// [D x M] tile for the MXU. Hopper gathers instead: the wrapper sorts the
// columns by bucket once per map (a stable argsort, so each bucket's columns
// stay in increasing order) and hands over order [D], offsets [M+1] (bucket
// j owns order[offsets[j] .. offsets[j+1]-1]; columns with h = -1 sort
// before offsets[0] and are never read) and the signs in sorted order.
//
// What bounds it on an H100: bytes at f32. At the Tab.2 setting (n =
// 188,000, D = 256, M = 128, C = 50) it reads 192.5 MB of rows (0.057 ms)
// and does 2*n*M*C = 2.4 GFLOP of f32 contraction (0.036 ms).
//
// What the design does: one CTA of 256 threads owns SBM = 64 rows and walks
// the buckets in chunks of SBE = 32. Each warp builds one row of the chunk
// z [64 x 32] in shared memory by a gather over its buckets' contiguous
// ranges of sorted columns (lane = bucket), so the sum order is fixed, two
// launches agree bitwise and no atomics are needed; every x element is read
// once per CTA. The chunk is then contracted against V's rows into the
// on-chip F [64 x Cp], 16 cluster columns at a time, and the argmin runs
// after the last chunk.
#include "common.cuh"
#include "row_block.cuh"

namespace rt {

constexpr int SBM = 64;                  // rows per CTA
constexpr int SBE = 32;                  // buckets per chunk (one per lane)
constexpr int ZS_LD = SBE + 1;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

inline size_t sketch_smem_bytes(int cp) {
  return sizeof(float) * (SBM * ZS_LD + SBE * HCH + SBM * cp);
}

template <class T, class S>
__global__ void __launch_bounds__(NTHREADS)
sketch_assign_kernel(const T* __restrict__ X, const int* __restrict__ order,
                     const int* __restrict__ offsets,
                     const S* __restrict__ sign, const float* __restrict__ V,
                     const float* __restrict__ csq, int* __restrict__ labels,
                     float* __restrict__ score, int n, int D, int M, int Cp) {
  extern __shared__ __align__(16) float sm[];
  float* zs = sm;                        // [SBM][ZS_LD]
  float* vs = zs + SBM * ZS_LD;          // [SBE][HCH]
  float* fs = vs + SBE * HCH;            // [SBM][Cp]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * SBM;
  for (int i = tid; i < SBM * Cp; i += NTHREADS) fs[i] = 0.0f;
  const int hc = tid & (HCH - 1), hr = tid >> 4;   // contraction mapping

  for (int j0 = 0; j0 < M; j0 += SBE) {
    // gather: warp w builds rows w, w+8, ..., lane = bucket j0 + lane
    const int j = j0 + lane;
    const int k0 = (j < M) ? __ldg(offsets + j) : 0;
    const int k1 = (j < M) ? __ldg(offsets + j + 1) : 0;
    for (int r = warp; r < SBM; r += NTHREADS / 32) {
      float z = 0.0f;
      if (r0 + r < n) {
        const T* xr = X + (size_t)(r0 + r) * D;
        for (int k = k0; k < k1; ++k)
          z = fmaf(to_float(__ldg(sign + k)), to_float(xr[__ldg(order + k)]), z);
      }
      zs[r * ZS_LD + lane] = z;
    }
    __syncthreads();

    // contract the chunk against V[j0 : j0 + SBE, :] into F
    for (int p0 = 0; p0 < Cp; p0 += HCH) {
      for (int i = tid; i < SBE * HCH; i += NTHREADS) {
        const int l = i / HCH, c = i % HCH;
        vs[i] = (j0 + l < M) ? __ldg(V + (size_t)(j0 + l) * Cp + p0 + c) : 0.0f;
      }
      __syncthreads();
      float a[SBM / 16];
#pragma unroll
      for (int q = 0; q < SBM / 16; ++q) a[q] = 0.0f;
#pragma unroll 8
      for (int l = 0; l < SBE; ++l) {
        const float pv = vs[l * HCH + hc];
#pragma unroll
        for (int q = 0; q < SBM / 16; ++q)
          a[q] = fmaf(zs[(hr + 16 * q) * ZS_LD + l], pv, a[q]);
      }
#pragma unroll
      for (int q = 0; q < SBM / 16; ++q) fs[(hr + 16 * q) * Cp + p0 + hc] += a[q];
      __syncthreads();
    }
  }
  row_block_argmin<SBM>(fs, csq, Cp, r0, n, labels, score);
}

template <class T, class S>
static int launch_sketch_assign(const void* x, const void* order,
                                const void* offsets, const void* sign,
                                const void* v, const void* csq, void* labels,
                                void* score, int n, int D, int M, int Cp,
                                void* stream) {
  if (Cp <= 0 || Cp > MAX_CP || Cp % HCH != 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = sketch_smem_bytes(Cp);
  const cudaError_t err = smem_once<sketch_assign_kernel<T, S>>(
      sketch_smem_bytes(MAX_CP), false);
  if (err != cudaSuccess) return (int)err;
  sketch_assign_kernel<T, S><<<(n + SBM - 1) / SBM, NTHREADS, bytes,
                               (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<const S*>(sign),
      static_cast<const float*>(v), static_cast<const float*>(csq),
      static_cast<int*>(labels), static_cast<float*>(score), n, D, M, Cp);
  return (int)cudaGetLastError();
}

}  // namespace rt

extern "C" int rt_sketch_assign_f32(const void* x, const void* order,
                                    const void* offsets, const void* sign,
                                    const void* v, const void* csq,
                                    void* labels, void* score, int n, int D,
                                    int M, int Cp, void* stream) {
  return rt::launch_sketch_assign<float, float>(
      x, order, offsets, sign, v, csq, labels, score, n, D, M, Cp, stream);
}

// bf16 rows, int8 signs (+-1 is exact in both)
extern "C" int rt_sketch_assign_bf16(const void* x, const void* order,
                                     const void* offsets, const void* sign,
                                     const void* v, const void* csq,
                                     void* labels, void* score, int n, int D,
                                     int M, int Cp, void* stream) {
  return rt::launch_sketch_assign<__nv_bfloat16, int8_t>(
      x, order, offsets, sign, v, csq, labels, score, n, D, M, Cp, stream);
}
