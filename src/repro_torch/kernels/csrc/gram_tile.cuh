// The Mercer and random Fourier epilogues of the port's Gram kernels, and
// TileBF16, the tile engine of the bf16 embed_assign body (row_block.cuh):
// one CTA of 256 threads computes a [128 x 128] tile of X . Y^T, reducing
// over the feature dimension D in chunks staged through shared memory.
//
//   TileBF16  bf16 operands, mma.sync.m16n8k16 bf16 -> f32 on the tensor
//             cores. 8 warps as 2 (rows) x 4 (cols), each warp a 64 x 32
//             sub-tile = 4 x 4 mma tiles; fragments are read from row-major
//             shared tiles whose 80-byte row stride keeps the reads free of
//             bank conflicts.
// It stages the next D-chunk from global memory into registers while the
// current chunk is multiplied out of shared memory (one chunk in flight).
// Rows past M, columns past N and features past D load as zeros, so the
// callers need not pad anything but D to the 16-byte vector width.
//
// Accumulator element e of a thread lies at tile position coord(e), 64
// elements per thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int BM = 128;        // tile rows (rows of X)
constexpr int BN = 128;        // tile cols (rows of Y: landmarks)
constexpr int NTHREADS = 256;
constexpr int NACC = 64;       // accumulator elements per thread

// RFF is no Mercer kind: it selects RffEpilogue (embed_assign.cu only)
enum Kind { LINEAR = 0, POLYNOMIAL = 1, COSINE = 2, RBF = 3, RFF = 4 };

struct Epilogue {
  int kind;
  float gamma;
  float coef0;
  int degree;

  // The reference's kernel_matrix._epilogue, term for term: rbf clamps the
  // squared distance at 0, cosine clamps the norm product at 1e-12.
  __device__ __forceinline__ float operator()(float acc, float xs,
                                              float ys) const {
    switch (kind) {
      case POLYNOMIAL: {
        float base = gamma * acc + coef0;
        float r = 1.0f;
        for (int i = 0; i < degree; ++i) r *= base;
        return r;
      }
      case COSINE: {
        float den = sqrtf(fmaxf(xs, 0.0f)) * sqrtf(fmaxf(ys, 0.0f));
        return acc / fmaxf(den, 1e-12f);
      }
      case RBF: {
        float d2 = fmaxf(xs + ys - 2.0f * acc, 0.0f);
        return expf(-gamma * d2);
      }
      default:
        return acc;
    }
  }
};

// The random Fourier feature map, scale * cos(x.w + b): ys carries the
// column's phase b (the slot of |y|^2 for the Mercer kinds), xs is unused.
// A type of its own, so the Mercer kernels compile no cosine. Full-range
// cosf, never __cosf: |x.w + b| grows with gamma and |x|, and __cosf loses
// its accuracy past a few multiples of pi.
struct RffEpilogue {
  float scale;   // sqrt(2/m)

  __device__ __forceinline__ float operator()(float acc, float,
                                              float ys) const {
    return scale * cosf(acc + ys);
  }
};

// The Mercer epilogue of kind KIND: the switch of Epilogue folds away, so
// that the accumulators of a body instantiated per kind meet one formula.
template <int KIND>
__device__ __forceinline__ float mercer(Epilogue e, float acc, float xs,
                                        float ys) {
  e.kind = KIND;
  return e(acc, xs, ys);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct TileBF16 {
  using T = __nv_bfloat16;
  static constexpr int BK = 32;   // features per staged chunk (2 mma k-steps)
  static constexpr int VEC = 8;   // bf16 per 16-byte load
  static constexpr int LDS = BK + 8;
  struct __align__(16) Smem {
    __nv_bfloat16 a[BM][LDS];     // row-major, 80-byte rows
    __nv_bfloat16 b[BN][LDS];
  };

  float acc[NACC];                // [mi 4][ni 4][q 4]

  __device__ __forceinline__ static void coord(int e, int& r, int& c) {
    const int mi = e >> 4, ni = (e >> 2) & 3, q = e & 3;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    r = (warp >> 2) * 64 + mi * 16 + (lane >> 2) + (q >> 1) * 8;
    c = (warp & 3) * 32 + ni * 8 + (lane & 3) * 2 + (q & 1);
  }

  __device__ __forceinline__ void compute(const __nv_bfloat16* __restrict__ X,
                                          const __nv_bfloat16* __restrict__ Y,
                                          int M, int N, int D, int r0, int c0,
                                          Smem& s) {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int wr = (warp >> 2) * 64, wc = (warp & 3) * 32;
    // staging: thread t moves row (t >> 2) + 64p, features (t & 3)*8 .. +7
    const int lr = tid >> 2, lk = (tid & 3) * VEC;
    uint4 ra[2], rb[2];
#pragma unroll
    for (int e = 0; e < NACC; ++e) acc[e] = 0.0f;

    auto load = [&](int k0) {
      const int k = k0 + lk;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int r = lr + 64 * p;
        const uint4 z = make_uint4(0u, 0u, 0u, 0u);
        ra[p] = (r0 + r < M && k < D)
            ? __ldg(reinterpret_cast<const uint4*>(X + (size_t)(r0 + r) * D + k))
            : z;
        rb[p] = (c0 + r < N && k < D)
            ? __ldg(reinterpret_cast<const uint4*>(Y + (size_t)(c0 + r) * D + k))
            : z;
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int r = lr + 64 * p;
        *reinterpret_cast<uint4*>(&s.a[r][lk]) = ra[p];
        *reinterpret_cast<uint4*>(&s.b[r][lk]) = rb[p];
      }
    };
    auto word = [](const __nv_bfloat16* p) {
      return *reinterpret_cast<const uint32_t*>(p);
    };

    load(0);
    for (int k0 = 0; k0 < D; k0 += BK) {
      store();
      __syncthreads();
      if (k0 + BK < D) load(k0 + BK);   // next chunk in flight
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        uint32_t af[4][4], bf[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          const int r = wr + mi * 16 + g;
          af[mi][0] = word(&s.a[r][ks + 2 * t]);
          af[mi][1] = word(&s.a[r + 8][ks + 2 * t]);
          af[mi][2] = word(&s.a[r][ks + 2 * t + 8]);
          af[mi][3] = word(&s.a[r + 8][ks + 2 * t + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int c = wc + ni * 8 + g;
          bf[ni][0] = word(&s.b[c][ks + 2 * t]);
          bf[ni][1] = word(&s.b[c][ks + 2 * t + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_bf16(&acc[(mi * 4 + ni) * 4], af[mi], bf[ni]);
      }
      __syncthreads();
    }
  }
};

}  // namespace rt
