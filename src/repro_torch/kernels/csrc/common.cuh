// Pieces shared by the port's hand-written bodies:
//   - cp.async helpers (16-byte copies into shared memory, commit, wait),
//     used by the cp.async rings of embed_f32.cuh, assign_f32.cuh and the
//     f32 flash body;
//   - 3xTF32 on the tensor cores: an f32 operand x is split into a TF32
//     high part hi (x rounded to TF32) and the residual lo = x - hi (exact
//     in f32), and each product a.b becomes a_lo.b_hi + a_hi.b_lo +
//     a_hi.b_hi with f32 accumulation (mma.sync m16n8k8 TF32). The dropped
//     a_lo.b_lo and the tensor core's truncation of lo sit near 2^-21 of
//     the product, a few times the rounding of f32 FMA;
//   - smem_once: the dynamic shared-memory attribute of a kernel, set once
//     per kernel and device. cudaFuncSetAttribute waits for the kernel's
//     launches still in flight, so calling it per launch leaves the card
//     idle while the host prepares the next one;
//   - Vec16: a 16-byte load of f32 or bf16 features as f32 values, and
//     row_sqnorms_kernel, the f32 squared norms of the rows of two
//     matrices (the assign_fused and embed_assign entries take their
//     norms from it);
//   - HCH and MAX_CP, the cluster panel's limits in the assignment bodies.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace rt {

// The assignment bodies (assign, embed_assign, sketch_assign) keep F [rows,
// Cp] on chip: Cp is at most MAX_CP clusters, a multiple of HCH where a
// body contracts HCH cluster columns at a time; the wrappers (ops.py)
// launch once per MAX_CP clusters beyond that.
constexpr int HCH = 16;
constexpr int MAX_CP = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src, or zeros when bytes == 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Split {
  uint32_t hi, lo;
};

// x as TF32 hi + lo (both as the 32-bit words mma takes). hi rounds the
// f32 bits to the nearest TF32 (ties away from zero) with an integer add
// and a mask, full-rate integer ops where cvt.rna.tf32.f32 runs on the
// conversion pipe at a fraction of that rate; lo = x - hi is exact in f32,
// and the tensor core reads its top 19 bits.
__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

// not volatile: the compiler may move independent products between two
// that share an accumulator
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Product p of the three that make d += a.b in 3xTF32 (a [4] and b [2]
// fragments of m16n8k8, each element split): 0 a_lo.b_hi, 1 a_hi.b_lo,
// 2 a_hi.b_hi, the small terms first. Callers run p = 0, 1, 2 in turn over
// a group of independent fragment pairs, so that the products sharing an
// accumulator are never issued back to back.
__device__ __forceinline__ void mma_3xtf32_part(int p, float* d,
                                                const Split* a,
                                                const Split* b) {
  const uint32_t av[4] = {p == 0 ? a[0].lo : a[0].hi,
                          p == 0 ? a[1].lo : a[1].hi,
                          p == 0 ? a[2].lo : a[2].hi,
                          p == 0 ? a[3].lo : a[3].hi};
  const uint32_t bv[2] = {p == 1 ? b[0].lo : b[0].hi,
                          p == 1 ? b[1].lo : b[1].hi};
  mma_tf32(d, av, bv);
}

// Set kernel K's dynamic shared-memory limit to `bytes` (the most any of
// its launches asks for) and, with max_carveout, prefer the largest
// shared-memory carveout (less L1), once per device. Two threads that race
// here both set the same attribute, which is harmless.
template <auto K>
cudaError_t smem_once(size_t bytes, bool max_carveout) {
  static std::atomic<unsigned long long> seen{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (seen.load() >> dev & 1ull)) return err;
  err = cudaFuncSetAttribute((const void*)K,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && max_carveout)
    err = cudaFuncSetAttribute((const void*)K,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) seen.fetch_or(1ull << dev);
  return err;
}

// 16 bytes of a row as floats
template <class T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int W = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[W]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[W]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // bf16 -> f32 is a 16-bit shift
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

constexpr int SQNORM_ROWS = 8;   // rows (warps) per block

// out[r] = |A_r|^2 for the na rows of A [na, D], then out[na + r] = |B_r|^2
// for the nb rows of B [nb, D], summed in f32 from the stored values, one
// warp a row (D a multiple of Vec16<T>::W)
template <class T>
__global__ void __launch_bounds__(32 * SQNORM_ROWS)
row_sqnorms_kernel(const T* __restrict__ A, int na, const T* __restrict__ B,
                   int nb, int D, float* __restrict__ out) {
  using V = Vec16<T>;
  const int row = blockIdx.x * SQNORM_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= na + nb) return;
  const T* src = row < na ? A + (size_t)row * D : B + (size_t)(row - na) * D;
  float s = 0.0f;
  for (int k = lane * V::W; k < D; k += 32 * V::W) {
    float v[V::W];
    V::load(src + k, v);
#pragma unroll
    for (int w = 0; w < V::W; ++w) s = fmaf(v[w], v[w], s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) out[row] = s;
}

// the squared norms of x [M, D] into norms[0, M) and of l [L, D] into
// norms[M, M + L); *lsq points at l's (at x's when l is x: the g stats
// pass one panel as both)
template <class T>
static int launch_sqnorms(const T* x, int M, const T* l, int L, int D,
                          float* norms, const float** lsq,
                          cudaStream_t stream) {
  const bool same = l == x && L == M;
  const int rows = M + (same ? 0 : L);
  *lsq = same ? norms : norms + M;
  row_sqnorms_kernel<T><<<(rows + SQNORM_ROWS - 1) / SQNORM_ROWS,
                          32 * SQNORM_ROWS, 0, stream>>>(
      x, M, l, rows - M, D, norms);
  return (int)cudaGetLastError();
}

}  // namespace rt
