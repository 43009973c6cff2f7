// flash_attention: O = softmax(mask(softcap(Q . K^T * dh^-1/2))) . V.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:85, body _kernel :40-82): causal or
// not, GQA (kv head = h / (H / KH), K and V never repeated in memory), an
// optional softcap cap * tanh(s / cap), an online softmax whose running max
// m, running sum l and [rows, dh] accumulator stay f32 on chip, and the
// output in the tiles' dtype. q is [B, H, Sq, dh], k and v [B, KH, Sk, dh],
// o [B, H, Sq, dh], all contiguous; dh is a multiple of 16 up to 256.
//
// The TPU grid ran its key axis in order on one core and carried m, l and
// the accumulator in scratch from step to step. Hopper runs blocks in no
// order, so one CTA owns a (b, h, 64-row query block) and loops over the key
// blocks itself; the loop stops at the diagonal when causal, so a key block
// wholly after the query block is skipped, not just masked (the TPU body's
// pl.when(live)). Keys at or past Sk and query rows at or past Sq are masked
// here (zero tiles, -1e30 scores, rows never stored), so the wrapper pads
// nothing. The constants are the reference's: m starts at -1e30, masked
// scores are -1e30 and l is floored at 1e-30, so every row stays finite.
//
// Four warps, 16 query rows each. A warp holds its [16, BK] score block and
// its [16, dh] accumulator in registers, in the C-fragment layout of
// mma.sync.m16n8k16 (lane = 4 g + t owns rows g and g + 8, columns 2t and
// 2t + 1 of every 8-column tile), so the row max and row sum reduce over
// the 4 lanes of a quad with two shuffles.
//   bf16 tiles: Q.K^T and P.V on the tensor cores (mma.sync, f32
//     accumulation). P is rounded to bf16 for the P.V product, as GPU
//     flash kernels do; the TPU body multiplied P in f32. l sums the f32 P.
//     V is staged transposed so its B fragments are 32-bit shared loads.
//   f32 tiles: both products in f32 FMA on the CUDA cores (no TF32); P
//     reaches the lanes that need it by quad shuffles.
// Softcap uses the full-precision tanhf, the softmax expf.
//
// What bounds it on an H100: at the main path's prefill (B 1, H = KH = 16,
// S 2048, dh 128, causal) the work is 4 * H * dh * S (S + 1) / 2 = 17.2
// GFLOP against 33.6 MB of q, k, v and o: ~510 flops per byte, above the
// bf16 ridge (~295), so operations bound it: 17 us at bf16, 0.26 ms at
// f32, at the published peaks of an H100 SXM at its 700 W limit. This first kernel is simple: K and V are
// staged through registers with no copy in flight, and mma.sync reads its
// fragments from shared memory without ldmatrix; wgmma, TMA and warp
// specialisation are later work.
#include "gram_tile.cuh"

namespace rt {
namespace fa {

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;
constexpr int BQ = 16 * NWARPS;    // query rows per CTA
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, KH, Sq, Sk, dh, causal;
  float scale, softcap;            // softcap <= 0: none
};

// rows [r0, r0 + rows) of a [*, dh] matrix into shared memory with leading
// dimension ld; rows at or past nvalid load as zeros
template <class T>
__device__ __forceinline__ void stage_rows(T* dst, int ld,
                                           const T* __restrict__ src, int r0,
                                           int nvalid, int rows, int dh) {
  constexpr int VEC = 16 / sizeof(T);
  const int vpr = dh / VEC;
  for (int i = threadIdx.x; i < rows * vpr; i += NTHREADS) {
    const int r = i / vpr, c = (i - r * vpr) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < nvalid)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * dh + c));
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 tiles on the tensor cores
template <int DHMAX, int BK_>
struct EngBF16 {
  using T = __nv_bfloat16;
  static constexpr int DH = DHMAX;        // largest head dim it takes
  static constexpr int BK = BK_;
  static constexpr int LDQ = DHMAX + 8;   // Q and K rows, 16-byte padded
  static constexpr int LDV = BK + 8;      // V^T rows
  static constexpr size_t smem_bytes() {
    return sizeof(T) * ((size_t)(BQ + BK) * LDQ + (size_t)DHMAX * LDV);
  }
  T* sq;
  T* sk;
  T* svt;

  __device__ __forceinline__ EngBF16(unsigned char* smem) {
    sq = reinterpret_cast<T*>(smem);
    sk = sq + BQ * LDQ;
    svt = sk + BK * LDQ;
  }

  __device__ __forceinline__ void stage_q(const T* Q, int q0, int Sq, int dh) {
    stage_rows(sq, LDQ, Q, q0, Sq, BQ, dh);
  }

  __device__ __forceinline__ void stage_kv(const T* K, const T* V, int k0,
                                           int Sk, int dh) {
    stage_rows(sk, LDQ, K, k0, Sk, BK, dh);
    // V transposed: consecutive threads take consecutive keys of one
    // 8-wide column chunk, so their 2-byte stores share words, not banks
    const int vpr = dh / 8;
    for (int i = threadIdx.x; i < BK * vpr; i += NTHREADS) {
      const int r = i % BK, c = (i / BK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k0 + r < Sk)
        val = __ldg(reinterpret_cast<const uint4*>(V + (size_t)(k0 + r) * dh + c));
      const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
      for (int u = 0; u < 8; ++u) svt[(c + u) * LDV + r] = e[u];
    }
  }

  __device__ __forceinline__ void scores(float (*S)[4], int dh) const {
    const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, t = lane & 3;
    const T* qa = sq + (wr + g) * LDQ + 2 * t;
    const T* qb = qa + 8 * LDQ;
#pragma unroll 2
    for (int kd = 0; kd < dh; kd += 16) {
      const uint32_t a[4] = {word(qa + kd), word(qb + kd), word(qa + kd + 8),
                             word(qb + kd + 8)};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const T* kr = sk + (8 * j + g) * LDQ + kd + 2 * t;
        const uint32_t b[2] = {word(kr), word(kr + 8)};
        mma_bf16(S[j], a, b);
      }
    }
  }

  __device__ __forceinline__ void pv(float (*S)[4], float (*O)[4],
                                     int dh) const {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16(S[2 * kk][0], S[2 * kk][1]),
          pack_bf16(S[2 * kk][2], S[2 * kk][3]),
          pack_bf16(S[2 * kk + 1][0], S[2 * kk + 1][1]),
          pack_bf16(S[2 * kk + 1][2], S[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < DHMAX / 8; ++n) {
        if (8 * n < dh) {
          const T* vr = svt + (8 * n + g) * LDV + 16 * kk + 2 * t;
          const uint32_t b[2] = {word(vr), word(vr + 8)};
          mma_bf16(O[n], a, b);
        }
      }
    }
  }

  __device__ __forceinline__ static void store2(T* dst, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
};

// f32 tiles, f32 FMA on the CUDA cores
template <int DHMAX, int BK_>
struct EngF32 {
  using T = float;
  static constexpr int DH = DHMAX;        // largest head dim it takes
  static constexpr int BK = BK_;
  static constexpr int LDQ = DHMAX + 4;   // Q, K and V rows, 16-byte padded
  static constexpr size_t smem_bytes() {
    return sizeof(T) * (size_t)(BQ + 2 * BK) * LDQ;
  }
  T* sq;
  T* sk;
  T* sv;

  __device__ __forceinline__ EngF32(unsigned char* smem) {
    sq = reinterpret_cast<T*>(smem);
    sk = sq + BQ * LDQ;
    sv = sk + BK * LDQ;
  }

  __device__ __forceinline__ void stage_q(const T* Q, int q0, int Sq, int dh) {
    stage_rows(sq, LDQ, Q, q0, Sq, BQ, dh);
  }

  __device__ __forceinline__ void stage_kv(const T* K, const T* V, int k0,
                                           int Sk, int dh) {
    stage_rows(sk, LDQ, K, k0, Sk, BK, dh);
    stage_rows(sv, LDQ, V, k0, Sk, BK, dh);
  }

  __device__ __forceinline__ void scores(float (*S)[4], int dh) const {
    const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * 16;
    const int g = lane >> 2, t = lane & 3;
    const T* qa = sq + (wr + g) * LDQ;
    const T* qb = qa + 8 * LDQ;
#pragma unroll 4
    for (int d = 0; d < dh; d += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qa + d);
      const float4 y = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const T* kr = sk + (8 * j + 2 * t) * LDQ + d;
        const float4 u = *reinterpret_cast<const float4*>(kr);
        const float4 w = *reinterpret_cast<const float4*>(kr + LDQ);
        S[j][0] = fmaf(x.w, u.w, fmaf(x.z, u.z, fmaf(x.y, u.y, fmaf(x.x, u.x, S[j][0]))));
        S[j][1] = fmaf(x.w, w.w, fmaf(x.z, w.z, fmaf(x.y, w.y, fmaf(x.x, w.x, S[j][1]))));
        S[j][2] = fmaf(y.w, u.w, fmaf(y.z, u.z, fmaf(y.y, u.y, fmaf(y.x, u.x, S[j][2]))));
        S[j][3] = fmaf(y.w, w.w, fmaf(y.z, w.z, fmaf(y.y, w.y, fmaf(y.x, w.x, S[j][3]))));
      }
    }
  }

  __device__ __forceinline__ void pv(float (*S)[4], float (*O)[4],
                                     int dh) const {
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;
#pragma unroll
    for (int c = 0; c < BK; ++c) {
      // key c's probabilities for rows g and g + 8 live in lane 4 g + (c % 8) / 2
      const int src = (lane & ~3) | ((c & 7) >> 1);
      const float pa = __shfl_sync(FULL, S[c >> 3][c & 1], src);
      const float pb = __shfl_sync(FULL, S[c >> 3][2 + (c & 1)], src);
      const T* vr = sv + c * LDQ + 2 * t;
#pragma unroll
      for (int n = 0; n < DHMAX / 8; ++n) {
        if (8 * n < dh) {
          const float2 vv = *reinterpret_cast<const float2*>(vr + 8 * n);
          O[n][0] = fmaf(pa, vv.x, O[n][0]);
          O[n][1] = fmaf(pa, vv.y, O[n][1]);
          O[n][2] = fmaf(pb, vv.x, O[n][2]);
          O[n][3] = fmaf(pb, vv.y, O[n][3]);
        }
      }
    }
  }

  __device__ __forceinline__ static void store2(T* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
};

template <class Eng>
__global__ void __launch_bounds__(NTHREADS) flash_kernel(Params p) {
  using T = typename Eng::T;
  constexpr int BK = Eng::BK, DHMAX = Eng::DH;
  extern __shared__ __align__(16) unsigned char smem[];
  Eng eng(smem);

  // the heaviest causal query blocks (the last ones) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KH);
  const int dh = p.dh;
  const T* Q = static_cast<const T*>(p.q) + (size_t)(b * p.H + h) * p.Sq * dh;
  const T* K = static_cast<const T*>(p.k) + (size_t)(b * p.KH + kvh) * p.Sk * dh;
  const T* V = static_cast<const T*>(p.v) + (size_t)(b * p.KH + kvh) * p.Sk * dh;
  T* O = static_cast<T*>(p.o) + (size_t)(b * p.H + h) * p.Sq * dh;

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_a = q0 + (threadIdx.x >> 5) * 16 + g;   // and row_a + 8

  float acc[DHMAX / 8][4];
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < DHMAX / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  eng.stage_q(Q, q0, p.Sq, dh);
  int n_kb = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);   // live blocks

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                 // the previous block's K and V are used
    eng.stage_kv(K, V, k0, p.Sk, dh);
    __syncthreads();

    float S[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.0f;
    eng.scores(S, dh);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = S[j][e] * p.scale;
        if (p.softcap > 0.0f) s = p.softcap * tanhf(s / p.softcap);
        const int row = row_a + (e >> 1) * 8, col = k0 + 8 * j + 2 * t + (e & 1);
        const bool live = col < p.Sk && (!p.causal || row >= col);
        S[j][e] = live ? s : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], S[j][e]);
      }
    }
    float corr[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      corr[r] = expf(m[r] - mx[r]);
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[j][e] = expf(S[j][e] - mx[e >> 1]);
        rsum[e >> 1] += S[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(FULL, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(FULL, rsum[r], 2);
      l[r] = l[r] * corr[r] + rsum[r];
    }
#pragma unroll
    for (int n = 0; n < DHMAX / 8; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }
    eng.pv(S, acc, dh);
  }

  const float la = fmaxf(l[0], 1e-30f), lb = fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int n = 0; n < DHMAX / 8; ++n) {
    if (8 * n < dh) {
      const int col = 8 * n + 2 * t;
      if (row_a < p.Sq)
        Eng::store2(O + (size_t)row_a * dh + col, acc[n][0] / la, acc[n][1] / la);
      if (row_a + 8 < p.Sq)
        Eng::store2(O + (size_t)(row_a + 8) * dh + col, acc[n][2] / lb,
                    acc[n][3] / lb);
    }
  }
}

template <class Eng>
static int launch(const Params& p, void* stream) {
  const size_t smem = Eng::smem_bytes();
  auto kernel = flash_kernel<Eng>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

static bool valid(const Params& p) {
  return p.dh >= 16 && p.dh <= 256 && p.dh % 16 == 0 && p.KH > 0 &&
         p.H % p.KH == 0 && p.Sq > 0 && p.Sk > 0 && p.B > 0;
}

}  // namespace fa
}  // namespace rt

extern "C" int rt_flash_attention_f32(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int KH, int Sq, int Sk, int dh,
                                      int causal, float scale, float softcap,
                                      void* stream) {
  using namespace rt::fa;
  const Params p{q, k, v, o, B, H, KH, Sq, Sk, dh, causal, scale, softcap};
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  if (dh <= 64) return launch<EngF32<64, 32>>(p, stream);
  if (dh <= 128) return launch<EngF32<128, 32>>(p, stream);
  return launch<EngF32<256, 32>>(p, stream);
}

extern "C" int rt_flash_attention_bf16(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int KH, int Sq, int Sk, int dh,
                                       int causal, float scale, float softcap,
                                       void* stream) {
  using namespace rt::fa;
  const Params p{q, k, v, o, B, H, KH, Sq, Sk, dh, causal, scale, softcap};
  if (!valid(p)) return (int)cudaErrorInvalidValue;
  if (dh <= 64) return launch<EngBF16<64, 64>>(p, stream);
  if (dh <= 128) return launch<EngBF16<128, 64>>(p, stream);
  return launch<EngBF16<256, 32>>(p, stream);
}
