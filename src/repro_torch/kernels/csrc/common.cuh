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
//     idle while the host prepares the next one.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace rt {

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

}  // namespace rt
