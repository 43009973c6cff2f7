// The bf16 body of assign.cu and of embed_assign.cu: the Gram tiles on
// wgmma from a TMA ring, the landmark axis split over the grid, the
// contraction against H in 3xTF32. body<KIND> is the whole CTA's work;
// assign_bf16_kernel (the Mercer kinds) and embed_assign.cu's
// embed_bf16_kernel (those and RFF, whose H is the value panel V and whose
// g is csq) are its two entries, launched by launch_body.
//
// Grid (splits, row blocks), as the f32 body (assign_f32.cuh): split s of
// S takes the landmark tiles [s T / S, (s + 1) T / S) of the T = ceil(L /
// BN) tiles (gf::range_begin); the launcher, kernels/assign.py
// landmark_splits, picks S from M, L, the SM count and the CTAs an SM
// holds (rt_assign_bf16_ctas_per_sm). One CTA of two warpgroups owns BM =
// 128 rows, 64 a warpgroup, and walks over its tiles of BN = 128
// landmarks. Its Gram tiles come from gram_bf16.cuh (the product loop the
// kernel_matrix bf16 tile body shares): wgmma m64n128k16 from a 3-stage
// TMA ring with 128-byte swizzle whose steps run on across the split's
// tiles. After a tile's last chunk the epilogue runs on the
// accumulators in registers (columns past L zeroed), and each warp
// contracts its 16 rows against H [L, Cp] with mma.sync m16n8k8 in 3xTF32
// (common.cuh), so the contraction keeps the f32 accuracy of the
// reference's f32 K . H: the wgmma accumulator of a warp has the mma.sync
// C-fragment layout (rows g and g + 8, columns 2t and 2t + 1 of every 8),
// which is the A-fragment of a k step whose slots t and t + 4 are
// landmarks 2t and 2t + 1, as in the f32 body. Two CTAs share an SM (at
// most 128 registers a thread, 105 KB of shared memory at C <= 16), so one
// CTA's epilogue and contraction run while the other's products occupy
// the tensor cores. The partial f [BM, Cp] of the split stays in shared
// memory, each element owned by one lane, and is written to part [S, M,
// Cp] at the end; af::assign_reduce_kernel sums the splits in a fixed
// order and takes the argmin, so two launches give the same bits. The
// contraction walks two landmark tiles of 8 at a time over all cluster
// columns, so their accumulators die as it goes (no spills at 128
// registers).
//
// What holds it back: each CTA reads 32 KB of stages a step from L2 for
// 2.1 MFLOP (64 flops a byte), so at the card's bf16 rate the SMs would
// draw more from L2 than it delivers; the contraction's mma.sync shares
// the tensor cores with the other CTA's wgmma. A variant that paired row
// blocks in clusters of two sharing the landmark half-tiles by TMA
// multicast read a quarter less from L2 but ran slower on the card (each
// pair waits for its slower CTA at every stage), so it is not used.
#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "assign_f32.cuh"
#include "gram_bf16.cuh"

namespace rt {
namespace ab {

using namespace rt::hop;
using gb::BM;                                 // rows per CTA, 64 a warpgroup
using gb::BN;                                 // landmarks per tile
using gb::NT;                                 // two warpgroups

// 1024 to align the ring to the swizzle period, the ring, f [BM][Cp] and
// the 2 NSTAGE mbarriers
inline size_t smem_bytes(int cp) {
  return 1024 + gb::RING_BYTES + sizeof(float) * (size_t)BM * cp +
         gb::BAR_BYTES;
}

// The epilogue of kind KIND: the random Fourier map for RFF (embed_assign
// only, in its outlined form), else the Mercer Epilogue with its switch
// folded to KIND.
template <int KIND>
using EpiOf = std::conditional_t<KIND == RFF, RffEpilogue, Epilogue>;

template <int KIND>
__device__ __forceinline__ float apply(const EpiOf<KIND>& epi, float acc,
                                       float xs, float ys) {
  if constexpr (KIND == RFF)
    return epi.outlined(acc, ys);
  else
    return mercer<KIND>(epi, acc, xs, ys);
}

// The epilogue on the accumulators of the tile from landmark l0, columns
// past L zeroed (an epilogue need not be 0 there: rbf gives exp(-gamma
// |x|^2), RFF scale cos(b)). Every element's formula runs and a select
// zeroes the padded ones, so no branch separates the elements and their
// formulas interleave, where a branch around each formula serialized them:
// 1.214 ms of the card a call at 15000 x 15000 x 784 against 1.365, and
// 0.206 against 0.223 for the Nystrom embedding of 60,000 x 784 -> 320
// (launch/kernel_ab.py on an H100).
template <int KIND>
__device__ __forceinline__ void epilogue(float (&acc)[BN / 2],
                                         const EpiOf<KIND>& epi,
                                         const float* __restrict__ lsq,
                                         const float (&xs)[2], int l0, int L,
                                         int t) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int gc = l0 + 8 * j + 2 * t + e;
      const bool in = gc < L;
      const float ys = in ? __ldg(lsq + gc) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& v = acc[4 * j + 2 * h + e];
        const float y = apply<KIND>(epi, v, xs[h], ys);
        v = in ? y : 0.0f;
      }
    }
  }
}

// f [16 rows of the warp][0, Cp) += tile . H[l0 : l0 + BN], JB landmark
// tiles of 8 at a time and, within them, 16 cluster columns at a time:
// landmark tile j of the C-fragments is k step j of the A-fragments. Each
// block of JB tiles is done with all cluster columns before the next, so
// its accumulators are dead once it is contracted. Two tiles a block; one
// for the cosine epilogue, whose divisions leave the contraction too few
// of the 128 registers for two (ptxas spilled 104 bytes). Blocks wholly
// past L are skipped (the last tile of a ragged L: at L = 320, half of
// it).
template <int JB>
__device__ __forceinline__ void contract(const float (&acc)[BN / 2],
                                         float* fw,
                                         const float* __restrict__ H, int l0,
                                         int L, int Cp, int g, int t) {
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += JB) {
    if (l0 + 8 * j0 >= L) break;
    for (int p0 = 0; p0 < Cp; p0 += 16) {
      float f[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[n][e] = 0.0f;
#pragma unroll
      for (int j = j0; j < j0 + JB; ++j) {
        const int la = l0 + 8 * j + 2 * t;   // slot t; slot t + 4: la + 1
        Split a[4], b[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float* hp = H + (size_t)la * Cp + p0 + 8 * n + g;
          b[n][0] = split_tf32(la < L ? __ldg(hp) : 0.0f);
          b[n][1] = split_tf32(la + 1 < L ? __ldg(hp + Cp) : 0.0f);
        }
        a[0] = split_tf32(acc[4 * j + 0]);
        a[1] = split_tf32(acc[4 * j + 2]);
        a[2] = split_tf32(acc[4 * j + 1]);
        a[3] = split_tf32(acc[4 * j + 3]);
#pragma unroll
        for (int p = 0; p < 3; ++p)
#pragma unroll
          for (int n = 0; n < 2; ++n) mma_3xtf32_part(p, f[n], a, b[n]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* q = reinterpret_cast<float2*>(fw + (8 * h + g) * Cp + p0 +
                                                8 * n + 2 * t);
          float2 cur = *q;
          cur.x += f[n][2 * h];
          cur.y += f[n][2 * h + 1];
          *q = cur;
        }
    }
  }
}

// part[split] = epi(X . L^T) . H over the split's landmark tiles of the
// row block. lsq: |l|^2 for the Mercer kinds, the phases b for RFF; xsq:
// |x|^2, which RFF never reads (null there). With labels (one split of
// embed_assign, whose f no caller reads) the body takes the argmin of gvec_j
// - 2 f_ij itself, as af::assign_reduce_kernel would, and writes no part.
template <int KIND>
__device__ __forceinline__ void body(
    const CUtensorMap* tx, const CUtensorMap* tl,
    const float* __restrict__ xsq, const float* __restrict__ lsq,
    const float* __restrict__ H, float* __restrict__ part,
    const float* __restrict__ gvec, int* __restrict__ labels,
    float* __restrict__ mind, int M, int L, int D, int Cp,
    const EpiOf<KIND>& epi) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  float* fs =
      reinterpret_cast<float*>(smem_raw + (ring - raw) + gb::RING_BYTES);
  const uint32_t bars =
      ring + gb::RING_BYTES + (uint32_t)(sizeof(float) * BM * Cp);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * BM;
  const int wg = warp >> 2;
  const int wr = 64 * wg + 16 * (warp & 3);   // the warp's first row
  // the warp's rows of f; lane (g, t) owns columns 2t, 2t + 1 of each 8 in
  // rows g and g + 8
  float* fw = fs + wr * Cp;
  for (int c = 2 * t; c < Cp; c += 8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(fw + (g + 8 * h) * Cp + c) =
          make_float2(0.0f, 0.0f);

  const int tiles = (L + BN - 1) / BN;
  const int tb = gf::range_begin(blockIdx.x, gridDim.x, tiles);
  const int te = gf::range_begin(blockIdx.x + 1, gridDim.x, tiles);
  // the split's tiles of this row block, in the ring's row-major order
  gb::Ring<false> rg(ring, bars, tx, tl, D, tiles, blockIdx.y * tiles + tb,
                     blockIdx.y * tiles + te);

  float xs_n[2] = {0.0f, 0.0f};               // |x|^2 of rows g, g + 8
  if constexpr (KIND != RFF) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gr = r0 + wr + g + 8 * h;
      xs_n[h] = gr < M ? __ldg(xsq + gr) : 0.0f;
    }
  }

  // acc[4 j + e]: row g + 8 (e >> 1), landmark 8 j + 2 t + (e & 1)
  float acc[BN / 2];
  for (int tile = tb; tile < te; ++tile) {
    rg.product(acc, tx, tl);

    const int l0 = tile * BN;
    epilogue<KIND>(acc, epi, lsq, xs_n, l0, L, t);
    contract<KIND == COSINE ? 1 : 2>(acc, fw, H, l0, L, Cp, g, t);
  }

  if (labels != nullptr) {
    // the first strict minimum of each row over the lane's columns in
    // order, then over the four lanes of the row: the lowest index wins
    // ties; the same d = g - 2 f, so the same bits as the reduction
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* fr = fw + (g + 8 * h) * Cp;
      float best = 0.0f;
      int arg = -1;
      for (int c = 2 * t; c < Cp; c += 8)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float d = __ldg(gvec + c + e) - 2.0f * fr[c + e];
          if (arg < 0 || d < best) {
            best = d;
            arg = c + e;
          }
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
        if (ob < best || (ob == best && oa < arg)) {
          best = ob;
          arg = oa;
        }
      }
      const int row = r0 + wr + g + 8 * h;
      if (t == 0 && row < M) {
        labels[row] = arg;
        mind[row] = best;
      }
    }
    return;
  }

  // this split's f for the warp's rows (each lane its own elements)
  float* out = part + ((size_t)blockIdx.x * M + r0 + wr) * Cp;
  for (int c = 2 * t; c < Cp; c += 8)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r0 + wr + g + 8 * h < M)
        *reinterpret_cast<float2*>(out + (size_t)(g + 8 * h) * Cp + c) =
            *reinterpret_cast<const float2*>(fw + (g + 8 * h) * Cp + c);
}

template <int KIND>
__global__ void __launch_bounds__(NT, 2)
assign_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                   const __grid_constant__ CUtensorMap tl,
                   const float* __restrict__ xsq,
                   const float* __restrict__ lsq,
                   const float* __restrict__ H, float* __restrict__ part,
                   int M, int L, int D, int Cp, Epilogue epi) {
  body<KIND>(&tx, &tl, xsq, lsq, H, part, nullptr, nullptr, nullptr, M, L, D,
             Cp, epi);
}

// Kernel K (an entry of kind KIND over body<KIND>, taking the arguments
// of assign_bf16_kernel, and with ARGMIN g, labels and mind after part)
// over x [M, D] and l [L, D], then the reduction of its splits against g
// into f, labels and mind; with ARGMIN and one split the kernel takes the
// argmin itself (no part, no f, no reduction). The Mercer kinds first sum
// the row norms of x and l into norms [M + L] (common.cuh
// launch_sqnorms); RFF reads the phases instead and no norms.
template <int KIND, auto K, bool ARGMIN>
static int launch_body(const __nv_bfloat16* x, const __nv_bfloat16* l,
                       float* norms, const float* phases, const float* h,
                       const float* g, int* labels, float* mind, float* f,
                       float* part, int M, int L, int D, int Cp, int splits,
                       const EpiOf<KIND>& epi, cudaStream_t stream) {
  const int tiles = (L + BN - 1) / BN;
  if (M <= 0 || L <= 0 || splits < 1 || splits > tiles)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tl;
  if (!encode_2d(&tx, x, M, D, D, BM) || !encode_2d(&tl, l, L, D, D, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = smem_once<K>(smem_bytes(MAX_CP), true);
  if (err != cudaSuccess) return (int)err;
  const float* xsq = nullptr;
  const float* lsq = phases;
  if constexpr (KIND != RFF) {
    if ((err = (cudaError_t)launch_sqnorms(x, M, l, L, D, norms, &lsq,
                                           stream)) != cudaSuccess)
      return (int)err;
    xsq = norms;
  }
  auto kernel = K;
  const dim3 grid(splits, (M + BM - 1) / BM);
  if constexpr (ARGMIN) {
    const bool here = splits == 1;
    kernel<<<grid, NT, smem_bytes(Cp), stream>>>(
        tx, tl, xsq, lsq, h, part, here ? g : nullptr,
        here ? labels : nullptr, here ? mind : nullptr, M, L, D, Cp, epi);
    err = cudaGetLastError();
    if (err != cudaSuccess || here) return (int)err;
  } else {
    kernel<<<grid, NT, smem_bytes(Cp), stream>>>(tx, tl, xsq, lsq, h, part,
                                                 M, L, D, Cp, epi);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  af::assign_reduce_kernel<af::REDUCE_ROWS>
      <<<(M + af::REDUCE_ROWS - 1) / af::REDUCE_ROWS, 32 * af::REDUCE_ROWS,
         0, stream>>>(part, splits, g, f, labels, mind, M, Cp);
  return (int)cudaGetLastError();
}

// CTAs of kernel K one SM holds at Cp clusters
template <auto K>
static int ctas_per_sm(int Cp, int* out) {
  const cudaError_t err = smem_once<K>(smem_bytes(MAX_CP), true);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, K, NT,
                                                            smem_bytes(Cp));
}

// norms [M + L] f32 scratch for the row norms of x and l; one
// instantiation per Mercer kind
static int dispatch(const __nv_bfloat16* x, const __nv_bfloat16* l,
                    float* norms, const float* h, const float* g, int* labels,
                    float* mind, float* f, float* part, int M, int L, int D,
                    int Cp, int splits, const Epilogue& epi,
                    cudaStream_t stream) {
#define RT_AB_CASE(K)                                                     \
  case K:                                                                 \
    return launch_body<K, assign_bf16_kernel<K>, false>(                  \
        x, l, norms, nullptr, h, g, labels, mind, f, part, M, L, D, Cp,   \
        splits, epi, stream);
  switch (epi.kind) {
    RT_AB_CASE(LINEAR)
    RT_AB_CASE(POLYNOMIAL)
    RT_AB_CASE(COSINE)
    RT_AB_CASE(RBF)
  }
#undef RT_AB_CASE
  return (int)cudaErrorInvalidValue;
}

static int dispatch_ctas_per_sm(int kind, int Cp, int* out) {
  switch (kind) {
    case LINEAR: return ctas_per_sm<assign_bf16_kernel<LINEAR>>(Cp, out);
    case POLYNOMIAL:
      return ctas_per_sm<assign_bf16_kernel<POLYNOMIAL>>(Cp, out);
    case COSINE: return ctas_per_sm<assign_bf16_kernel<COSINE>>(Cp, out);
    case RBF: return ctas_per_sm<assign_bf16_kernel<RBF>>(Cp, out);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ab
}  // namespace rt
