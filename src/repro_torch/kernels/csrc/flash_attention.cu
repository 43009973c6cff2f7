// flash_attention: O = softmax(mask(softcap(Q . K^T * dh^-1/2))) . V.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:85, body _kernel :40-82): causal or
// not, GQA (kv head = h / (H / KH), K and V never repeated in memory), an
// optional softcap cap * tanh(s / cap), an online softmax whose running max
// m, running sum l and [rows, dh] accumulator stay f32 on chip, and the
// output in the tiles' dtype. q is [B, H, Sq, dh], k and v [B, KH, Sk, dh],
// o [B, H, Sq, dh]; dh is a multiple of 16 up to 256.
//
// The TPU grid ran its key axis in order on one core and carried m, l and
// the accumulator in scratch from step to step. Hopper runs blocks in no
// order, so one CTA owns a (b, h, query block) and loops over the key blocks
// itself; the loop stops at the diagonal when causal, so a key block wholly
// after the query block is skipped, not just masked (the TPU body's
// pl.when(live)), and the heaviest causal query blocks start first. Keys at
// or past Sk and query rows at or past Sq are masked here (zero tiles,
// -1e30 scores, rows never stored), so the wrapper pads nothing. The
// constants are the reference's: m starts at -1e30, masked scores are -1e30
// and l is floored at 1e-30, so every row stays finite. Softcap uses the
// full-precision tanhf.
//
// What bounds it on an H100: at the main path's prefill (B 1, H = KH = 16,
// S 2048, dh 128, causal) the work is 4 * H * dh * S (S + 1) / 2 = 17.2
// GFLOP against 33.6 MB of q, k, v and o: ~510 flops per byte, above the
// bf16 ridge (~295), so operations bound it: 17 us at bf16, 0.26 ms at
// f32, at the published peaks of an H100 SXM at its 700 W limit.
//
// Two bodies:
//   f32 tiles (rt_flash_attention_f32, namespace fa): one CTA of four warps
//     per 64-row query block, 16 rows a warp; K and V staged through
//     registers; both products in f32 FMA on the CUDA cores (no TF32), the
//     score block and the accumulator in the mma.m16n8k16 C-fragment layout
//     (lane = 4 g + t owns rows g and g + 8, columns 2t and 2t + 1 of every
//     8-column tile), P moved to the lanes that need it by quad shuffles;
//     expf. Contiguous operands only.
//   bf16 tiles (rt_flash_attention_bf16, namespace fa3), built for the
//     tensor cores' rate: one CTA per 128 query rows of one (b, h), as two
//     consumer warpgroups of 64 rows and one producer warpgroup whose
//     registers go to the consumers (setmaxnreg). One producer thread keeps
//     Q and a two-stage ring of K and V tiles loaded by TMA into 128-byte
//     swizzled shared memory, on mbarrier transaction counts, from tensor
//     maps that carry each operand's strides (the [B, S, H, dh] activations
//     are read in place). S = Q . K^T is wgmma m64nBKk16 with both operands
//     in shared memory; the softmax runs on the wgmma accumulator (the same
//     C-fragment layout, rows reduced over a quad) with exp2f and the scale
//     times log2(e) folded in; P becomes bf16 in registers as the A operand
//     of O += P . V, whose B operand is V as loaded, MN-major (wgmma's
//     transpose bit), so nothing is transposed. The mask runs only on key
//     blocks that cross the diagonal or Sk. TMA fills the columns past dh
//     and the rows past Sq or Sk with zeros, so every dh of the wrapper
//     runs in one of three tilings (dh padded to 64, 128 or 256) and the
//     stores are clipped. P is rounded to bf16 for the P.V product, as GPU
//     flash kernels do; the TPU body multiplied P in f32. l sums the f32 P.
//     The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//     found through cudaGetDriverEntryPoint (no -lcuda at link time).
#include "gram_tile.cuh"
#include "hopper.cuh"

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


// ---------------------------------------------------------------------------
// bf16 body: TMA, wgmma, warp specialisation
// ---------------------------------------------------------------------------

namespace rt {
namespace fa3 {

using namespace rt::hop;

constexpr int BQ = 128;              // query rows per CTA
constexpr int NCONS = 256;           // two consumer warpgroups of 64 rows
constexpr int NTHR = NCONS + 128;    // and the producer warpgroup
constexpr int NSTAGE = 2;            // K/V ring
constexpr int CH = 64;               // dh columns per 128-byte swizzled chunk
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;   // o's element strides: batch, head, row
  int H, KH, Sq, Sk, dh, causal;
  float score_mul;   // log2(e) dh^-1/2, or dh^-1/2 / cap with a softcap
  float cap_mul;     // cap log2(e), or 0: no softcap
};

// Shared memory: Q [NCH chunks][BQ rows][128 B], then K and V, each
// [NSTAGE][NCH][BK rows][128 B], then the mbarriers. Every chunk starts on
// a 1024-byte boundary, the period of the 128-byte swizzle.
template <int DHP, int BK>
struct Tiles {
  static constexpr int NCH = DHP / CH;
  static constexpr uint32_t Q_CHUNK = BQ * 128;
  static constexpr uint32_t KV_CHUNK = BK * 128;
  static constexpr uint32_t Q_BYTES = NCH * Q_CHUNK;
  static constexpr uint32_t KV_BYTES = NCH * KV_CHUNK;   // one stage of K or V
  static constexpr uint32_t BAR_OFF = Q_BYTES + 2 * NSTAGE * KV_BYTES;
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * NSTAGE);
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_words(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The scaled scores of one key block in log2 units, masked where MASK,
// folded into the running max m and sum l (a per-thread partial of its
// quad's row); returns the factor by which the accumulator rows shrink.
// sc[4 j + e] holds row row_a + 8 (e >> 1), key col0 + 8 j + (e & 1).
template <bool MASK, int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&corr)[2],
                                               const Params& p, int row_a,
                                               int col0) {
  if (p.cap_mul > 0.0f) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      sc[i] = p.cap_mul * tanhf(sc[i] * p.score_mul);
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] *= p.score_mul;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int row = row_a + 8 * (e >> 1), col = col0 + 8 * j + (e & 1);
        if (col >= p.Sk || (p.causal && col > row)) sc[4 * j + e] = NEG;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
    }
  }
  float rsum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    corr[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    sc[i] = exp2f(sc[i] - mx[(i >> 1) & 1]);
    rsum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rsum[r];
}

template <int DHP, int BK>
__global__ void __launch_bounds__(NTHR, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Tiles<DHP, BK>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + L::Q_BYTES;
  const uint32_t sv = sk + NSTAGE * L::KV_BYTES;
  const uint32_t bar_q = sq + L::BAR_OFF;
  auto full_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto full_v = [&](int s) { return bar_q + 8u * (1 + NSTAGE + s); };
  auto empty = [&](int s) { return bar_q + 8u * (1 + 2 * NSTAGE + s); };

  // the heaviest causal query blocks (the last ones) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  int n_kb = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);   // live blocks

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), NCONS / 32);   // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // ---- producer: one thread issues every load --------------------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == NCONS) {
      const int kvh = h / (p.H / p.KH);
      tma_prefetch(&tq);
      tma_prefetch(&tk);
      tma_prefetch(&tv);
      mbar_expect_tx(bar_q, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::NCH; ++c)
        tma_load_4d(sq + c * L::Q_CHUNK, &tq, bar_q, c * CH, q0, h, b);
      for (int kb = 0; kb < n_kb; ++kb) {
        const int s = kb % NSTAGE;
        // stage s is free once every consumer warp is done with block
        // kb - NSTAGE
        if (kb >= NSTAGE) mbar_wait(empty(s), ((kb / NSTAGE) & 1) ^ 1);
        const uint32_t ks = sk + s * L::KV_BYTES, vs = sv + s * L::KV_BYTES;
        mbar_expect_tx(full_k(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          tma_load_4d(ks + c * L::KV_CHUNK, &tk, full_k(s), c * CH, kb * BK,
                      kvh, b);
        mbar_expect_tx(full_v(s), L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::NCH; ++c)
          tma_load_4d(vs + c * L::KV_CHUNK, &tv, full_v(s), c * CH, kb * BK,
                      kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows a warpgroup ----------------------------
    setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_wg = q0 + 64 * wg;                 // first row of the group
    const int row_a = r_wg + 16 * warp + g;        // and row_a + 8
    const bool rows_live = r_wg < p.Sq;
    const uint32_t qa = sq + wg * 64 * 128;        // its rows of each Q chunk

    float o[DHP / 2];
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) o[i] = 0.0f;
    float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};

    mbar_wait(bar_q, 0);
    for (int kb = 0; kb < n_kb; ++kb) {
      const int s = kb % NSTAGE;
      const uint32_t par = (kb / NSTAGE) & 1;
      const int k0 = kb * BK;
      const uint32_t ks = sk + s * L::KV_BYTES, vs = sv + s * L::KV_BYTES;
      // a block wholly after this group's rows adds nothing (its scores
      // would all be -1e30 against a finite m); its loads are still
      // waited for, so no copy is in flight when the stage is released
      const bool live = rows_live && (!p.causal || k0 <= r_wg + 63);
      float sc[BK / 2];
      uint32_t pa[BK / 16][4];
      mbar_wait(full_k(s), par);
      if (live) {
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < DHP / 16; ++kd) {
          const uint32_t off = (kd & 3) * 32;   // 16 columns = 32 bytes
          wgmma_ss(sc, desc_sw128(qa + (kd >> 2) * L::Q_CHUNK + off, 0),
                   desc_sw128(ks + (kd >> 2) * L::KV_CHUNK + off, 0), kd > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        float corr[2];
        if (k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > r_wg))
          online_softmax<true, BK>(sc, m, l, corr, p, row_a, k0 + 2 * t);
        else
          online_softmax<false, BK>(sc, m, l, corr, p, row_a, k0 + 2 * t);
#pragma unroll
        for (int i = 0; i < DHP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          pa[kk][0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
          pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
          pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
          pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
        }
      }
      mbar_wait(full_v(s), par);
      if (live) {
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)   // 16 keys = 2048 bytes of V
          wgmma_rs_tb(o, pa[kk], desc_sw128(vs + kk * 2048, L::KV_CHUNK), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(o);
        fence_words(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }

    if (rows_live) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        inv[r] = 1.0f / fmaxf(l[r], 1e-30f);
      }
      __nv_bfloat16* O = p.o + (size_t)b * p.o_sb + (size_t)h * p.o_sh;
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (col < p.dh) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row_a + 8 * r;
            if (row < p.Sq)
              *reinterpret_cast<__nv_bfloat162*>(O + (size_t)row * p.o_ss + col) =
                  __floats2bfloat162_rn(o[4 * j + 2 * r] * inv[r],
                                        o[4 * j + 2 * r + 1] * inv[r]);
          }
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// A [B, heads, S, dh] bf16 operand with element strides (sb, sh, ss) and
// unit stride along dh, read in boxes of 64 columns by `rows` rows,
// 128-byte swizzled; out-of-bounds elements load as zeros.
static bool encode(CUtensorMap* map, const void* ptr, int B, int heads, int S,
                   int dh, long long sb, long long sh, long long ss,
                   int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)S,
                              (cuuint64_t)heads, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CH, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP, int BK>
static int launch(const void* q, const void* k, const void* v, int B,
                  const long long* st, const Params& p, void* stream) {
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, p.H, p.Sq, p.dh, st[0], st[1], st[2], BQ) ||
      !encode(&tk, k, B, p.KH, p.Sk, p.dh, st[3], st[4], st[5], BK) ||
      !encode(&tv, v, B, p.KH, p.Sk, p.dh, st[6], st[7], st[8], BK))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = Tiles<DHP, BK>::SMEM;
  auto kernel = flash_bf16_kernel<DHP, BK>;
  // once per instantiation and device: the call costs host time
  static unsigned long long sized = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (!(sized >> dev & 1ull)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized |= 1ull << dev;
  }
  const dim3 grid(B * p.H, (p.Sq + BQ - 1) / BQ);
  kernel<<<grid, NTHR, smem, (cudaStream_t)stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace fa3
}  // namespace rt

// strides: element strides (batch, head, row) of q, k, v and o, in that
// order; each a multiple of 8 (16 bytes), dh contiguous
extern "C" int rt_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KH, int Sq, int Sk, int dh, int causal, float scale, float softcap,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  using namespace rt::fa3;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  const rt::fa::Params shape{q, k, v, o, B, H, KH, Sq, Sk, dh, causal, scale,
                             softcap};
  if (!rt::fa::valid(shape)) return (int)cudaErrorInvalidValue;
  for (long long s : st)
    if (s <= 0 || s % 8) return (int)cudaErrorInvalidValue;
  const bool cap = softcap > 0.0f;
  const Params p{static_cast<__nv_bfloat16*>(o), o_sb, o_sh, o_ss, H, KH, Sq,
                 Sk, dh, causal,
                 cap ? scale / softcap : scale * LOG2E,
                 cap ? softcap * LOG2E : 0.0f};
  if (dh <= 64) return launch<64, 128>(q, k, v, B, st, p, stream);
  if (dh <= 128) return launch<128, 128>(q, k, v, B, st, p, stream);
  return launch<256, 64>(q, k, v, B, st, p, stream);
}
