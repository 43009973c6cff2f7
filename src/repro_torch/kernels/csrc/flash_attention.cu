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
// bf16 ridge (~295), so operations bound it: 17 us at bf16 (989 TFLOP/s),
// 0.10 ms at f32-accurate 3xTF32 (495 / 3 = 165 TFLOP/s), at the published
// peaks of an H100 SXM at its 700 W limit.
//
// Two bodies, both reading q, k and v and writing o through their strides
// (dh contiguous, 16-byte aligned rows), so the [B, S, H, dh] activations
// are used in place:
//   f32 tiles (rt_flash_attention_f32, namespace fa): both products on the
//     tensor cores in 3xTF32 (common.cuh), mma.sync m16n8k8, so the result
//     keeps f32 accuracy. One CTA per (b, h, query block) of NW warps of 16
//     rows; Q and a two-stage ring of K/V blocks land in padded shared
//     memory by cp.async, the next block's copies in flight while the
//     current one is multiplied. Three tilings: dh up to 64 (8 warps, key
//     blocks of 32, two CTAs per SM), up to 128 (8 warps, 64 keys), up to
//     256 (4 warps, 32 keys; 128 accumulators a thread). The scores and the
//     accumulator are C-fragments (lane 4 g + t: rows g and g + 8, columns
//     2t and 2t + 1 of every 8-column tile). The k slots of an m16n8k8 step
//     may hold any keys as long as A and B agree, so P's C-fragment of key
//     tile j is the A-fragment of a step whose slots t and t + 4 are keys
//     2t and 2t + 1, and V's B-fragment is rows 2t and 2t + 1 at column g:
//     P moves between the two products without a shuffle. A warp skips a
//     key block wholly after its rows; the mask runs only on blocks that
//     cross the diagonal or Sk. expf, as the reference.
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
#include <cuda_bf16.h>

#include "common.cuh"
#include "hopper.cuh"

namespace rt {
namespace fa {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

// element strides (batch, head, row) of each operand; dh is contiguous
struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
      o_ss;
  int H, KH, Sq, Sk, dh, causal;
  float scale, softcap;            // softcap <= 0: none
};

static bool valid(int B, int H, int KH, int Sq, int Sk, int dh) {
  return dh >= 16 && dh <= 256 && dh % 16 == 0 && KH > 0 && H % KH == 0 &&
         Sq > 0 && Sk > 0 && B > 0;
}

// A tiling: head dims up to DHP, NW warps of 16 query rows, key blocks of
// BK. Q and K rows are padded to DHP + 8 floats (8 mod 32: the float2
// fragment reads of a half-warp fall in distinct banks), V rows to DHP + 4
// (4 mod 32: lane (g, t) reads V rows 2t and 2t + 1 at column g, banks
// 8t + g).
template <int DHP, int NW, int BK>
struct Tiling {
  static constexpr int NT = 32 * NW;
  static constexpr int BQ = 16 * NW;
  static constexpr int LDK = DHP + 8;
  static constexpr int LDV = DHP + 4;
  static constexpr size_t SMEM =
      sizeof(float) * ((size_t)BQ * LDK + 2 * BK * LDK + 2 * BK * LDV);
};

template <int DHP, int NW, int BK>
__global__ void __launch_bounds__(32 * NW, DHP <= 64 ? 2 : 1)
flash_f32_kernel(const Params p) {
  using T = Tiling<DHP, NW, BK>;
  constexpr int NT = T::NT, BQ = T::BQ, LDK = T::LDK, LDV = T::LDV;
  extern __shared__ __align__(16) float sm[];
  float* sq = sm;                          // [BQ][LDK]
  float* sk = sq + BQ * LDK;               // [2][BK][LDK]
  float* sv = sk + 2 * BK * LDK;           // [2][BK][LDV]

  // the heaviest causal query blocks (the last ones) start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / (p.H / p.KH);
  const int dh = p.dh;
  constexpr int VPR = DHP / 4;             // 16-byte copies per row
  const float* Q = p.q + (size_t)b * p.q_sb + (size_t)h * p.q_sh;
  const float* K = p.k + (size_t)b * p.k_sb + (size_t)kvh * p.k_sh;
  const float* V = p.v + (size_t)b * p.v_sb + (size_t)kvh * p.v_sh;

  // rows [r0, r0 + rows) of a strided operand into shared memory of pitch
  // ld, DHP columns; rows at or past n and columns at or past dh load as
  // zeros, so the products run over all DHP columns without a branch
  auto stage_rows = [&](float* dst, int ld, const float* src, long long ss,
                        int r0, int rows, int n) {
    const uint32_t base = smem_addr(dst);
    for (int i = threadIdx.x; i < rows * VPR; i += NT) {
      const int r = i / VPR, c = (i % VPR) * 4;
      const bool ok = r0 + r < n && c < dh;
      cp_async16(base + (r * ld + c) * 4,
                 ok ? src + (size_t)(r0 + r) * ss + c : src, ok ? 16 : 0);
    }
  };
  auto stage_kv = [&](int kb) {
    const int s = kb & 1;
    stage_rows(sk + s * BK * LDK, LDK, K, p.k_ss, kb * BK, BK, p.Sk);
    stage_rows(sv + s * BK * LDV, LDV, V, p.v_ss, kb * BK, BK, p.Sk);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = q0 + 16 * warp;           // the warp's first row
  const int row_a = rw + g;                // and row_a + 8

  float acc[DHP / 8][4];
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  int n_kb = (p.Sk + BK - 1) / BK;
  if (p.causal) n_kb = min(n_kb, (q0 + BQ + BK - 1) / BK);   // live blocks

  stage_rows(sq, LDK, Q, p.q_ss, q0, BQ, p.Sq);
  stage_kv(0);
  cp_commit();
  for (int kb = 0; kb < n_kb; ++kb) {
    cp_wait<0>();      // block kb (and Q) landed: this thread's copies
    __syncthreads();   // everyone's; block kb - 1 is no longer read
    if (kb + 1 < n_kb) stage_kv(kb + 1);   // in flight while kb is used
    cp_commit();
    const int k0 = kb * BK;
    // a block wholly after the warp's rows adds nothing (every score -1e30
    // against a finite m): skipped, as are rows wholly past Sq
    if (rw >= p.Sq || (p.causal && k0 > rw + 15)) continue;
    const float* ks = sk + (kb & 1) * BK * LDK;
    const float* vs = sv + (kb & 1) * BK * LDV;

    // S = Q . K^T: slot t of a k step is dim 2t, slot t + 4 dim 2t + 1
    float S[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) S[j][0] = S[j][1] = S[j][2] = S[j][3] = 0.0f;
    const float* qa = sq + (16 * warp + g) * LDK + 2 * t;
    const float* kr = ks + g * LDK + 2 * t;
#pragma unroll
    for (int d = 0; d < DHP; d += 8) {
      {
        const float2 u = *reinterpret_cast<const float2*>(qa + d);
        const float2 w = *reinterpret_cast<const float2*>(qa + 8 * LDK + d);
        const Split a[4] = {split_tf32(u.x), split_tf32(w.x), split_tf32(u.y),
                            split_tf32(w.y)};
        Split bb[BK / 8][2];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * j * LDK + d);
          bb[j][0] = split_tf32(kv.x);
          bb[j][1] = split_tf32(kv.y);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) mma_3xtf32_part(q, S[j], a, bb[j]);
      }
    }

    // online softmax on the C-fragments: S[j][e] is row row_a + 8 (e >> 1),
    // key k0 + 8 j + 2 t + (e & 1)
    const bool mask = k0 + BK > p.Sk || (p.causal && k0 + BK - 1 > rw);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = S[j][e] * p.scale;
        if (p.softcap > 0.0f) s = p.softcap * tanhf(s / p.softcap);
        if (mask) {
          const int row = row_a + (e >> 1) * 8, col = k0 + 8 * j + 2 * t + (e & 1);
          if (col >= p.Sk || (p.causal && col > row)) s = NEG;
        }
        S[j][e] = s;
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
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
    for (int n = 0; n < DHP / 8; ++n) {
      acc[n][0] *= corr[0]; acc[n][1] *= corr[0];
      acc[n][2] *= corr[1]; acc[n][3] *= corr[1];
    }

    // O += P . V: the C-fragment of key tile j is the A-fragment of a k
    // step whose slot t is key 2t and slot t + 4 key 2t + 1; V's B-fragment
    // follows (rows 2t and 2t + 1, column g)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const Split a[4] = {split_tf32(S[j][0]), split_tf32(S[j][2]),
                          split_tf32(S[j][1]), split_tf32(S[j][3])};
      const float* vr = vs + (8 * j + 2 * t) * LDV + g;
      // eight column tiles at a time
#pragma unroll
      for (int n0 = 0; n0 < DHP / 8; n0 += 8) {
        Split bb[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          bb[n][0] = split_tf32(vr[8 * (n0 + n)]);
          bb[n][1] = split_tf32(vr[LDV + 8 * (n0 + n)]);
        }
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int n = 0; n < 8; ++n) mma_3xtf32_part(q, acc[n0 + n], a, bb[n]);
      }
    }
  }

  if (rw >= p.Sq) return;
  const float la = fmaxf(l[0], 1e-30f), lb = fmaxf(l[1], 1e-30f);
  float* O = p.o + (size_t)b * p.o_sb + (size_t)h * p.o_sh;
#pragma unroll
  for (int n = 0; n < DHP / 8; ++n) {
    if (8 * n < dh) {
      const int col = 8 * n + 2 * t;
      if (row_a < p.Sq)
        *reinterpret_cast<float2*>(O + (size_t)row_a * p.o_ss + col) =
            make_float2(acc[n][0] / la, acc[n][1] / la);
      if (row_a + 8 < p.Sq)
        *reinterpret_cast<float2*>(O + (size_t)(row_a + 8) * p.o_ss + col) =
            make_float2(acc[n][2] / lb, acc[n][3] / lb);
    }
  }
}

template <int DHP, int NW, int BK>
static int launch(const Params& p, int B, void* stream) {
  using T = Tiling<DHP, NW, BK>;
  auto kernel = flash_f32_kernel<DHP, NW, BK>;
  const cudaError_t err =
      smem_once<flash_f32_kernel<DHP, NW, BK>>(T::SMEM, true);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * p.H, (p.Sq + T::BQ - 1) / T::BQ);
  kernel<<<grid, T::NT, T::SMEM, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace fa
}  // namespace rt

// strides: element strides (batch, head, row) of q, k, v and o, in that
// order; each a multiple of 4 (16 bytes), dh contiguous
extern "C" int rt_flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int KH, int Sq, int Sk, int dh, int causal, float scale, float softcap,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb,
    long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, long long o_sb, long long o_sh, long long o_ss,
    void* stream) {
  using namespace rt::fa;
  if (!valid(B, H, KH, Sq, Sk, dh)) return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
                            v_sb, v_sh, v_ss, o_sb, o_sh, o_ss};
  for (long long s : st)
    if (s <= 0 || s % 4) return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(q), static_cast<const float*>(k),
                 static_cast<const float*>(v), static_cast<float*>(o),
                 q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                 o_sb, o_sh, o_ss, H, KH, Sq, Sk, dh, causal, scale, softcap};
  if (dh <= 64) return launch<64, 8, 32>(p, B, stream);
  if (dh <= 128) return launch<128, 8, 64>(p, B, stream);
  return launch<256, 4, 32>(p, B, stream);
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
  const cudaError_t err = smem_once<flash_bf16_kernel<DHP, BK>>(smem, false);
  if (err != cudaSuccess) return (int)err;
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
  if (!rt::fa::valid(B, H, KH, Sq, Sk, dh)) return (int)cudaErrorInvalidValue;
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
