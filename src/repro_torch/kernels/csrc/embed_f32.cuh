// The f32 engine of embed_assign.cu: f32 FMA on the CUDA cores (no TF32)
// at two CTAs of 256 threads per SM (at most 128 registers a thread), with
// the X and W chunks streamed through a cp.async ring.
//
// One CTA owns BM rows of X and loops over the column tiles of the map
// panel W [M, D] (BN columns each) and, within a tile, over D in chunks of
// KC features. The (tile, chunk) steps form one sequence, so the ring runs
// on across tiles. Each step copies X [BM, KC] and W [BN, KC] row-major
// into a stage with 16-byte cp.async copies (rows past n or M and features
// past D zero-filled); NSTAGE - 1 steps are in flight while one is
// multiplied, behind one barrier per step. The rows are padded to LD = KC
// + 4 floats, so the float4 reads of the FMA loop along k fall in distinct
// bank groups for eight consecutive rows. A thread owns rows ty + TY i
// (i < TM) and columns tx + TX j (j < TN): the TX threads of a row read
// distinct W rows, and all of them read the same X row (a broadcast).
//
// The launcher (kernels/embed_assign.py f32_geometry) picks the column
// tile from M, BN in {160, 80, 40, 20}, so that padded columns stay under
// 1/8 of the work where they can; each tile has one row block (dispatch
// below), 80 rows for the wide tiles, whose grid at n = 60,000 fills 95%
// of three whole waves of 2 x 132 CTAs. After the last chunk of a tile
// the epilogue runs (RFF in registers; the Mercer kinds from the parked
// tile, once the accumulators are dead), columns past M are zeroed, and
// the tile is contracted against V [M, C] into F [BM, C], which stays in
// shared memory across the tiles; then each row takes min_j (csq_j - 2
// F_ij) and its lowest index. C is any count up to 256 (no padding:
// columns of V past C load as zeros and the argmin stops at C).
#pragma once

#include "common.cuh"
#include "epilogue.cuh"

namespace rt {
namespace ef {

constexpr int NT = 256;        // threads per CTA

// KC features per step, rows padded to LD = KC + 4 floats, a ring of
// NSTAGE steps
template <int TX, int TN, int TM, int KC, int NSTAGE>
struct Geo {
  static constexpr int LD = KC + 4;
  static constexpr int QPR = KC / 4;        // 16-byte copies per row
  static constexpr int TY = NT / TX;
  static constexpr int BM = TY * TM;       // rows per CTA
  static constexpr int BN = TX * TN;       // columns per tile
  static constexpr int EL = BN + 4;        // parked tile pitch (16-byte rows)
  static constexpr int STAGE = (BM + BN) * LD;
  static constexpr size_t smem_bytes(int cp) {   // cp: F's row pitch
    return sizeof(float) * ((size_t)NSTAGE * STAGE + (size_t)BM * EL +
                            (size_t)BN * HCH + (size_t)BM * cp);
  }
  static_assert(BM % 16 == 0 && BM <= NT && BN % 4 == 0,
                "contraction and argmin map");
  static_assert(KC % 8 == 0, "LD / 4 odd: eight rows in distinct banks");
};

// The RFF epilogue reads no |x|^2 (its caller passes no row norms) and
// its cosine fits in registers beside the accumulators; the Mercer kinds
// read both norms and run from the parked tile.
template <class Epi>
struct IsRff {
  static constexpr bool value = false;
};
template <>
struct IsRff<RffEpilogue> {
  static constexpr bool value = true;
};

template <int TX, int TN, int TM, int KC, int NSTAGE, class Epi>
__global__ void __launch_bounds__(NT, 2)
embed_assign_f32_kernel(const float* __restrict__ X,
                        const float* __restrict__ W,
                        const float* __restrict__ xsq,
                        const float* __restrict__ aux,
                        const float* __restrict__ V,
                        const float* __restrict__ csq,
                        int* __restrict__ labels, float* __restrict__ score,
                        int n, int M, int D, int C, Epi epi) {
  using G = Geo<TX, TN, TM, KC, NSTAGE>;
  const int Cp = (C + HCH - 1) / HCH * HCH;   // F's row pitch
  constexpr int LD = G::LD, QPR = G::QPR;
  constexpr int COPIES = (G::BM + G::BN) * QPR;   // per step
  extern __shared__ __align__(16) float sm[];
  float* ring = sm;                          // [NSTAGE][BM + BN][LD]
  float* es = ring + NSTAGE * G::STAGE;      // [BM][EL]  the parked tile
  float* vs = es + G::BM * G::EL;            // [BN][HCH] one chunk of V
  float* fs = vs + G::BN * HCH;              // [BM][Cp]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int r0 = blockIdx.x * G::BM;
  for (int i = tid; i < G::BM * Cp; i += NT) fs[i] = 0.0f;

  const int nsteps = ((D + KC - 1) / KC) * ((M + G::BN - 1) / G::BN);

  // The producer side walks the steps in order: (column tile c0, chunk k0)
  // advance by counters, never by division. Every thread commits one group
  // per step, empty or not. Copy i of a step is row i / QPR, features
  // (i % QPR) * 4 .. + 3 of the chunk.
  const uint32_t ring_addr = smem_addr(ring);
  int is_c0 = 0, is_k0 = 0, is_stage = 0, issued = 0;
  auto issue = [&]() {
    if (issued < nsteps) {
      const uint32_t st = ring_addr + is_stage * G::STAGE * 4;
#pragma unroll
      for (int u = 0; u < (COPIES + NT - 1) / NT; ++u) {
        const int i = tid + NT * u;
        if (COPIES % NT == 0 || i < COPIES) {
          const int r = i / QPR, kq = (i % QPR) * 4, k = is_k0 + kq;
          const bool in_x = r < G::BM;
          const int gr = in_x ? r0 + r : is_c0 + r - G::BM;
          const bool ok = gr < (in_x ? n : M) && k < D;
          const float* src = (in_x ? X : W) + (ok ? (size_t)gr * D + k : 0);
          cp_async16(st + (r * LD + kq) * 4, src, ok ? 16 : 0);
        }
      }
      ++issued;
      is_stage = is_stage + 1 == NSTAGE ? 0 : is_stage + 1;
      is_k0 += KC;
      if (is_k0 >= D) {
        is_k0 = 0;
        is_c0 += G::BN;
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue();

  float acc[TM][TN];
  int c0 = 0, k0 = 0, stage = 0;   // the step being multiplied
  for (int s = 0; s < nsteps; ++s) {
    if (k0 == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
    }
    cp_wait<NSTAGE - 2>();   // step s has landed (this thread's copies)
    __syncthreads();         // everyone's copies; step s - 1 is multiplied
    issue();                 // step s + NSTAGE - 1, into step s - 1's stage
    const float* xs = ring + stage * G::STAGE;
    stage = stage + 1 == NSTAGE ? 0 : stage + 1;
    const float* ws = xs + G::BM * LD;
#pragma unroll
    for (int k = 0; k < KC; k += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(xs + (ty + G::TY * i) * LD + k);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(ws + (tx + TX * j) * LD + k);
#pragma unroll
        for (int i = 0; i < TM; ++i)
          acc[i][j] = fmaf(a[i].w, b.w,
                           fmaf(a[i].z, b.z,
                                fmaf(a[i].y, b.y, fmaf(a[i].x, b.x, acc[i][j]))));
      }
    }
    k0 += KC;
    if (k0 < D) continue;

    // the tile is complete: apply the epilogue (RFF: in registers; Mercer:
    // from the parked tile, once the accumulators are dead, so that its
    // branches cost no registers beside them), park it, contract against V
    k0 = 0;
    if (IsRff<Epi>::value) {
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + G::TY * i, gr = r0 + r;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int c = tx + TX * j, gc = c0 + c;
          // columns past M contribute nothing
          es[r * G::EL + c] =
              (gr < n && gc < M) ? epi(acc[i][j], 0.0f, __ldg(aux + gc)) : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          es[(ty + G::TY * i) * G::EL + tx + TX * j] = acc[i][j];
      __syncthreads();
      for (int e = tid; e < G::BM * G::BN; e += NT) {
        const int r = e / G::BN, c = e % G::BN, gr = r0 + r, gc = c0 + c;
        float* p = es + r * G::EL + c;
        *p = (gr < n && gc < M) ? epi(*p, __ldg(xsq + gr), __ldg(aux + gc))
                                : 0.0f;
      }
    }
    // thread owns cluster column hc of a chunk and rows hr + 16 u
    const int hc = tid & (HCH - 1), hr = tid / HCH;
    for (int p0 = 0; p0 < Cp; p0 += HCH) {
      for (int i = tid; i < G::BN * HCH; i += NT) {
        const int l = i / HCH, j = p0 + i % HCH;
        vs[i] = (c0 + l < M && j < C) ? __ldg(V + (size_t)(c0 + l) * C + j)
                                      : 0.0f;
      }
      __syncthreads();   // the parked tile and this chunk of V
      float f[G::BM / 16];
#pragma unroll
      for (int u = 0; u < G::BM / 16; ++u) f[u] = 0.0f;
#pragma unroll 2
      for (int l = 0; l < G::BN; l += 4) {
        const float p0v = vs[l * HCH + hc], p1v = vs[(l + 1) * HCH + hc];
        const float p2v = vs[(l + 2) * HCH + hc], p3v = vs[(l + 3) * HCH + hc];
#pragma unroll
        for (int u = 0; u < G::BM / 16; ++u) {
          const float4 e =
              *reinterpret_cast<const float4*>(es + (hr + 16 * u) * G::EL + l);
          f[u] = fmaf(e.w, p3v, fmaf(e.z, p2v, fmaf(e.y, p1v, fmaf(e.x, p0v, f[u]))));
        }
      }
#pragma unroll
      for (int u = 0; u < G::BM / 16; ++u) fs[(hr + 16 * u) * Cp + p0 + hc] += f[u];
      __syncthreads();   // es and vs are free again
    }
    c0 += G::BN;
  }
  // the first strict minimum of csq_j - 2 F_ij over the C clusters: the
  // lowest index wins ties
  if (tid < G::BM && r0 + tid < n) {
    const float* fr = fs + tid * Cp;
    float best = __ldg(csq) - 2.0f * fr[0];
    int arg = 0;
    for (int c = 1; c < C; ++c) {
      const float d = __ldg(csq + c) - 2.0f * fr[c];
      if (d < best) {
        best = d;
        arg = c;
      }
    }
    labels[r0 + tid] = arg;
    score[r0 + tid] = best;
  }
}

template <int TX, int TN, int TM, int KC, int NSTAGE, class Epi>
static int launch(const void* x, const void* w, const void* xsq,
                  const void* aux, const void* v, const void* csq,
                  void* labels, void* score, int n, int M, int D, int C,
                  Epi epi, void* stream) {
  using G = Geo<TX, TN, TM, KC, NSTAGE>;
  const size_t bytes = G::smem_bytes((C + HCH - 1) / HCH * HCH);
  auto kernel = embed_assign_f32_kernel<TX, TN, TM, KC, NSTAGE, Epi>;
  // sized once per instantiation and device, to the largest F (MAX_CP
  // clusters)
  const cudaError_t err =
      smem_once<embed_assign_f32_kernel<TX, TN, TM, KC, NSTAGE, Epi>>(
          G::smem_bytes(MAX_CP), true);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(n + G::BM - 1) / G::BM, NT, bytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(xsq), static_cast<const float*>(aux),
      static_cast<const float*>(v), static_cast<const float*>(csq),
      static_cast<int*>(labels), static_cast<float*>(score), n, M, D, C, epi);
  return (int)cudaGetLastError();
}

// the geometries the launcher may ask for: (BN, BM); kernels/embed_assign.py
// F32_GEOMETRY lists the same
template <class Epi>
static int dispatch(int bn, int bm, const void* x, const void* w,
                    const void* xsq, const void* aux, const void* v,
                    const void* csq, void* labels, void* score, int n, int M,
                    int D, int C, Epi epi, void* stream) {
#define RT_EF_CASE(BN_, BM_, TX, TN, TM, KC, NS)                              \
  if (bn == BN_ && bm == BM_)                                                \
    return launch<TX, TN, TM, KC, NS>(x, w, xsq, aux, v, csq, labels, score,  \
                                      n, M, D, C, epi, stream);
  RT_EF_CASE(160, 80, 32, 5, 10, 16, 2)
  RT_EF_CASE(80, 80, 16, 5, 5, 32, 2)
  RT_EF_CASE(40, 128, 8, 5, 4, 32, 3)
  RT_EF_CASE(20, 128, 4, 5, 2, 32, 3)
#undef RT_EF_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace ef
}  // namespace rt
