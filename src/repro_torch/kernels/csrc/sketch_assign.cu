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
// [D x M] tile for the MXU. Hopper gathers instead, from a program the
// wrapper builds once per map and chunk width (kernels/sketch_assign.py
// gather_program): the columns with h >= 0, sorted by (column chunk c,
// warp w = h mod 8, bucket, column), each an int2 {column within its chunk
// | sign in the top bit, bucket | first << 30 | last << 29} (first and last
// of its bucket within the chunk), and pos [nch][MP], the program index of
// the first entry of bucket j (or of the end of its warp's group) in chunk
// c. So a warp's entries of one chunk and one bucket chunk are one
// contiguous run.
//
// What bounds it on an H100: bytes. At the Tab.2 setting (n = 188,000, D =
// 256, M = 128, C = 50) it reads 192.5 MB of f32 rows (0.057 ms; 0.029 ms
// at bf16) and does 2 n M Cp = 3.1 GFLOP of contraction, 9.2 GFLOP of
// TF32 products in 3xTF32 (0.019 ms at the tensor cores' peak). The gather
// and the contraction have to hide under the loads, bf16's too.
//
// What the design does:
//   - a persistent grid, the SMs times the CTAs one holds (two where the
//     shared memory allows; kernels/sketch_assign.py geometry), each CTA
//     walking a contiguous range of row blocks of R = 32 rows. It loads
//     V [MB, Cp] f32 (a row pitch of 8 mod 32 floats: conflict-free
//     fragment reads) once;
//   - the program lies where it costs nothing: a narrow one (the Tab.2
//     dense view's 256 columns: 2 KB) is copied to shared memory once per
//     CTA, beside the ring, when it leaves the bucket chunk and the CTAs an
//     SM holds as they are without it; any other is read in place from
//     global memory (L2) chunk by chunk, each warp's run with warp-uniform
//     __ldg broadcasts, so shared memory does not grow with D and the
//     kernel takes rows of any width (Tab.2's 47,236-term vocabulary).
//     Read in place, the narrow program cost Tab.2's dense view 5% on an
//     H100 SXM at 700 W (0.199 against 0.189 ms at f32,
//     launch/kernel_ab.py), so it stays staged where it fits;
//   - X is staged in order through a cp.async ring of NSTAGE = 3 stages,
//     16-byte copies, each stage a column chunk of the row block: 512
//     bytes a row (KD = 128 f32 or 256 bf16 features), so the next chunks'
//     loads are in flight while one is gathered. Rows are read once per
//     launch when the buckets fit in one chunk of MB (the main shape);
//     otherwise V is reloaded and X re-streamed per bucket chunk;
//   - the gather: lane r of every warp owns row r of the block, and warp w
//     owns buckets w, w + 8, ...; it walks its run of the program as one
//     flat loop with the same trip count in every lane (the entries are
//     warp-uniform broadcast reads), the next two entries and their x
//     loaded ahead of the current one's fmaf. z_j of a row is the fmaf
//     chain over the bucket's columns in increasing index from 0, the
//     parent kernel's order, carried across column chunks in zT: z is
//     bitwise the same, and two launches agree bitwise; no atomics. zT
//     [MB][R + 8] is bucket-major, so a warp's loads and stores and the
//     fragment reads are conflict-free;
//   - the contraction F = z . V on the tensor cores: mma.sync m16n8k8 in
//     3xTF32 (common.cuh), warp w holding m-tile w & 1 and the n-tiles
//     w / 2 + 4 i of F in registers across the bucket chunks; the reference
//     contracts an f32 z against f32 V, so bf16 rows keep this product
//     f32-accurate. V is kept in f32 and split when its fragments load: the
//     split pair would double its shared memory and cost the second CTA;
//   - the argmin of csq - 2F: each lane over its columns in increasing
//     order, then over the four lanes of a row and the four warps of an
//     m-tile, ties to the lower index (the lowest index overall).
// The sketch as a tensor-core product with the +-1/0 matrix (the TPU's
// way) would do 2 n D M = 12.3 GFLOP more, and not give the parent's z.
//
// What holds it back (Tab.2's shape on an H100; launch/kernel_ab.py
// times it at C = 10, 50 and 200 and at D = 128, and PERF.md keeps the
// numbers): the phases add up more than they overlap.
// The 3xTF32 contraction is bound by the rate of mma.sync TF32, and its
// time follows C; with 16-byte staging and a lane a row, each x read of
// the gather is a 4-way bank conflict (a 16-byte granule fixes a column's
// word within it, so 32 rows reach 8 banks at most). Sharing V between
// two row blocks of one CTA, or staging rows with 4-byte copies at an odd
// pitch, are untried.
#include <type_traits>

#include "common.cuh"

namespace rt {
namespace sk {

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int R = 32;                     // rows per block, one a lane
constexpr int ROW_BYTES = 512;            // of a row per ring stage
constexpr int PITCH = ROW_BYTES + 16;     // a staged row, bytes
constexpr int NSTAGE = 3;
constexpr int STAGE = R * PITCH;          // bytes
constexpr int CPR = ROW_BYTES / 16;       // 16-byte copies a row
constexpr int ZP = R + 8;                 // zT row pitch, 8 mod 32
constexpr int NG = 4;                     // n-tile groups (warps per m-tile)
static_assert(NT % CPR == 0 && R % (NT / CPR) == 0, "copies of a stage");

// V's row pitch: 8 mod 32 floats
__host__ __device__ __forceinline__ int vpitch(int cp) {
  return (cp + 31) / 32 * 32 + 8;
}

// pos's row: buckets rounded to 8, and 8 more for the groups' ends
__host__ __device__ __forceinline__ int mpos(int m) {
  return (m + 7) / 8 * 8 + 8;
}

// Shared memory for a program of E entries over nch column chunks, M
// buckets, Cp clusters and bucket chunks of mb (kernels/sketch_assign.py
// smem_bytes mirrors it): the ring, zT [mb][ZP], V [mb][vpitch], where
// the program is staged its [E] int2 and pos [nch][mpos(M)], and the
// argmin's [R][NG] best and index
inline size_t smem_bytes(int e, int nch, int m, int cp, int mb, bool staged) {
  return (size_t)NSTAGE * STAGE +
         4 * ((size_t)mb * ZP + (size_t)mb * vpitch(cp)) +
         (staged ? 8 * (((size_t)e + 1) / 2 * 2) +
                       4 * (((size_t)nch * mpos(m) + 3) / 4 * 4)
                 : 0) +
         8 * R * NG;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

constexpr int FIRST = 1 << 30, LAST = 1 << 29, BUCKET = (1 << 29) - 1;

// A warp's run [k0, k1) of the program over its rows (xs: this lane's
// staged row of the chunk, zl: this lane's column of zT, jb: the bucket
// chunk's first bucket): a flat loop, each entry and its x loaded two
// entries ahead of its fmaf, so no load waits on the chain
template <class T>
__device__ __forceinline__ void gather(const int2* __restrict__ prog, int k0,
                                       int k1, const T* __restrict__ xs,
                                       float* __restrict__ zl, int jb) {
  if (k0 >= k1) return;
  int2 e0 = prog[k0];
  int2 e1 = k0 + 1 < k1 ? prog[k0 + 1] : e0;
  float x0 = to_float(xs[e0.x & 0x7fffffff]);
  float x1 = to_float(xs[e1.x & 0x7fffffff]);
  float z = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const int2 e2 = k + 2 < k1 ? prog[k + 2] : e0;
    const float x2 = to_float(xs[e2.x & 0x7fffffff]);
    const int jl = (e0.y & BUCKET) - jb;
    if (e0.y & FIRST) z = zl[jl * ZP];
    z = fmaf(e0.x < 0 ? -1.0f : 1.0f, x0, z);
    if (e0.y & LAST) zl[jl * ZP] = z;
    e0 = e1;
    x0 = x1;
    e1 = e2;
    x1 = x2;
  }
}

// (value, index) pairs: ob at oa beats best at arg (arg < 0: none yet)
__device__ __forceinline__ bool beats(float ob, int oa, float best, int arg) {
  return oa >= 0 && (arg < 0 || ob < best || (ob == best && oa < arg));
}

// X [n, Dp] rows (Dp: the row stride), the program of E entries, V [M, Cp],
// bucket chunks of MB (a multiple of 8); NTW >= the n-tiles a warp holds,
// ceil(Cp / 8 / NG), so that F takes only the registers it needs; STAGED:
// the program and pos are copied to shared memory, else read from global
template <class T, int NTW, bool STAGED>
__global__ void __launch_bounds__(NT, 2)
sketch_kernel(const T* __restrict__ X, const int2* __restrict__ program,
              const int* __restrict__ positions,
              const float* __restrict__ V, const float* __restrict__ csq,
              int* __restrict__ labels, float* __restrict__ score, int n,
              int E, int Dp, int M, int Cp, int MB) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int VP = vpitch(Cp), MP = mpos(M);
  float* zt = reinterpret_cast<float*>(sm + NSTAGE * STAGE);   // [MB][ZP]
  float* vs = zt + MB * ZP;                                    // [MB][VP]
  // where the program is staged: [E] int2 and pos [nch][MP] after V
  int2* sprog = reinterpret_cast<int2*>(vs + MB * VP);
  int* spos = reinterpret_cast<int*>(sprog + (E + 1) / 2 * 2);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  constexpr int KD = ROW_BYTES / (int)sizeof(T);   // features per chunk
  constexpr int W = 16 / (int)sizeof(T);           // features per copy
  const int nch = (Dp + KD - 1) / KD;
  const int nb = (M + MB - 1) / MB;
  const int2* prog = STAGED ? sprog : program;
  const int* pos = STAGED ? spos : positions;
  float* rbest = STAGED ? reinterpret_cast<float*>(
                              spos + (nch * MP + 3) / 4 * 4)
                        : reinterpret_cast<float*>(sprog);     // [R][NG]
  int* rarg = reinterpret_cast<int*>(rbest + R * NG);          // [R][NG]
  const int blocks = (n + R - 1) / R;
  const int rb0 = (int)((long long)blockIdx.x * blocks / gridDim.x);
  const int rb1 = (int)((long long)(blockIdx.x + 1) * blocks / gridDim.x);

  // the program and its positions, once
  if constexpr (STAGED) {
    for (int k = tid; k < E; k += NT) sprog[k] = __ldg(program + k);
    for (int i = tid; i < nch * MP; i += NT) spos[i] = __ldg(positions + i);
  }
  // V rows [jb, jb + MB) of bucket chunk b, zero past M
  auto load_v = [&](int jb) {
    for (int i = tid; i < MB * Cp; i += NT) {
      const int jl = i / Cp, c = i % Cp;
      vs[jl * VP + c] = jb + jl < M ? __ldg(V + (size_t)(jb + jl) * Cp + c)
                                    : 0.0f;
    }
  };
  if (nb == 1) load_v(0);   // once per CTA

  // the producer walks the steps (row block, bucket chunk, column chunk)
  // in order; a thread copies piece cq of rows cr + (NT / CPR) u of a stage
  const int cr = tid / CPR, cq = tid % CPR;
  const uint32_t dst0 = smem_addr(sm) + cr * PITCH + cq * 16;
  int is_rb = rb0, is_b = 0, is_c = 0, is_stage = 0;
  int left = (rb1 - rb0) * nb * nch;
  auto issue = [&]() {
    if (left > 0) {
      const uint32_t st = dst0 + is_stage * STAGE;
      const int col = is_c * KD + cq * W;
#pragma unroll
      for (int u = 0; u < R / (NT / CPR); ++u) {
        const int row = is_rb * R + cr + (NT / CPR) * u;
        const bool ok = col < Dp && row < n;
        cp_async16(st + (NT / CPR) * u * PITCH,
                   ok ? X + (size_t)row * Dp + col : X, ok ? 16 : 0);
      }
      --left;
      is_stage = is_stage + 1 == NSTAGE ? 0 : is_stage + 1;
      if (++is_c == nch) {
        is_c = 0;
        if (++is_b == nb) {
          is_b = 0;
          ++is_rb;
        }
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) issue();

  const int mt = warp & 1, ng = warp >> 1;   // m-tile, n-tile group
  const int ntiles = Cp / 8;
  // a warp with many n-tiles loads their B fragments four at a time, so
  // that they fit its registers beside F
  constexpr int NB = NTW < 4 ? NTW : 4;
  float f[NTW][4];
#pragma unroll
  for (int i = 0; i < NTW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[i][e] = 0.0f;
  int stage = 0;
  for (int rb = rb0; rb < rb1; ++rb) {
    for (int b = 0; b < nb; ++b) {
      const int jb = b * MB;
      const int mbc = min(MB, M - jb);         // buckets of the chunk
      const int mbk = (mbc + 7) / 8 * 8;       // rounded to whole k steps
      for (int c = 0; c < nch; ++c) {
        cp_wait<NSTAGE - 2>();   // this step has landed (this thread's)
        __syncthreads();         // everyone's; the last contraction is done
        issue();                 // NSTAGE - 1 steps ahead
        if (c == 0 && nb > 1) load_v(jb);
        const T* xs = reinterpret_cast<const T*>(sm + stage * STAGE +
                                                 lane * PITCH);
        stage = stage + 1 == NSTAGE ? 0 : stage + 1;
        // gather: at the first chunk the warp's buckets start at 0; then
        // its run of the program for (chunk c, this bucket chunk)
        if (c == 0)
          for (int jl = warp; jl < mbk; jl += NW) zt[jl * ZP + lane] = 0.0f;
        const int* pc = pos + c * MP + warp;
        gather<T>(prog, pc[jb], pc[min(jb + MB, MP - 8)], xs, zt + lane, jb);
        if (c + 1 < nch) continue;
        __syncthreads();   // z of the chunk complete (and its V loaded)

        // F += z . V over the chunk's buckets: k step kk is buckets
        // 8 kk .. 8 kk + 7, the B fragments of NB n-tiles at a time
        for (int kk = 0; kk < mbk / 8; ++kk) {
          const float* zp = zt + (8 * kk + t) * ZP + 16 * mt + g;
          Split a[4];
          a[0] = split_tf32(zp[0]);            // row g,     slot t
          a[1] = split_tf32(zp[8]);            // row g + 8, slot t
          a[2] = split_tf32(zp[4 * ZP]);       // row g,     slot t + 4
          a[3] = split_tf32(zp[4 * ZP + 8]);   // row g + 8, slot t + 4
          const float* vp = vs + (8 * kk + t) * VP + g;
#pragma unroll
          for (int i0 = 0; i0 < NTW; i0 += NB) {
            Split bf[NB][2];
#pragma unroll
            for (int i = 0; i < NB; ++i) {
              const int nt = ng + NG * (i0 + i);
              if (nt < ntiles) {
                bf[i][0] = split_tf32(vp[8 * nt]);
                bf[i][1] = split_tf32(vp[4 * VP + 8 * nt]);
              }
            }
#pragma unroll
            for (int p = 0; p < 3; ++p)
#pragma unroll
              for (int i = 0; i < NB; ++i)
                if (ng + NG * (i0 + i) < ntiles)
                  mma_3xtf32_part(p, f[i0 + i], a, bf[i]);
          }
        }
        if (b + 1 < nb) continue;

        // argmin of csq - 2F: lane (g, t) over its columns 8 nt + 2t + e
        // of rows g + 8h, in increasing order, then the lanes of a row
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float best = 0.0f;
          int arg = -1;
#pragma unroll
          for (int i = 0; i < NTW; ++i) {
            const int nt = ng + NG * i;
            if (nt < ntiles) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int col = 8 * nt + 2 * t + e;
                const float d = __ldg(csq + col) - 2.0f * f[i][2 * h + e];
                if (arg < 0 || d < best) {
                  best = d;
                  arg = col;
                }
              }
            }
          }
#pragma unroll
          for (int o = 1; o < 4; o <<= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, o);
            const int oa = __shfl_xor_sync(0xffffffffu, arg, o);
            if (beats(ob, oa, best, arg)) {
              best = ob;
              arg = oa;
            }
          }
          if (t == 0) {
            rbest[(16 * mt + 8 * h + g) * NG + ng] = best;
            rarg[(16 * mt + 8 * h + g) * NG + ng] = arg;
          }
        }
#pragma unroll
        for (int i = 0; i < NTW; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) f[i][e] = 0.0f;
        __syncthreads();
        // over the n-tile groups of a row
        if (tid < R && rb * R + tid < n) {
          float best = rbest[tid * NG];
          int arg = rarg[tid * NG];
#pragma unroll
          for (int q = 1; q < NG; ++q)
            if (beats(rbest[tid * NG + q], rarg[tid * NG + q], best, arg)) {
              best = rbest[tid * NG + q];
              arg = rarg[tid * NG + q];
            }
          labels[rb * R + tid] = arg;
          score[rb * R + tid] = best;
        }
      }
    }
  }
}

template <class T, int NTW, bool STAGED>
static int launch_ntw(const void* x, const void* program,
                      const void* positions, const void* v, const void* csq,
                      void* labels, void* score, int n, int E, int Dp, int M,
                      int Cp, int MB, int ctas, void* stream) {
  constexpr int KD = ROW_BYTES / (int)sizeof(T);
  if (n <= 0 || E < 0 || Dp <= 0 || Dp % (16 / (int)sizeof(T)) != 0 ||
      M <= 0 || Cp <= 0 || Cp > MAX_CP || Cp % 8 != 0 || MB <= 0 ||
      MB % 8 != 0 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes =
      smem_bytes(E, (Dp + KD - 1) / KD, M, Cp, MB, STAGED);
  constexpr size_t SMEM_BLOCK = 232448;   // the most a block may use
  if (bytes > SMEM_BLOCK) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      smem_once<sketch_kernel<T, NTW, STAGED>>(SMEM_BLOCK, true);
  if (err != cudaSuccess) return (int)err;
  sketch_kernel<T, NTW, STAGED><<<ctas, NT, bytes, (cudaStream_t)stream>>>(
      static_cast<const T*>(x), static_cast<const int2*>(program),
      static_cast<const int*>(positions), static_cast<const float*>(v),
      static_cast<const float*>(csq), static_cast<int*>(labels),
      static_cast<float*>(score), n, E, Dp, M, Cp, MB);
  return (int)cudaGetLastError();
}

// the instantiation of the fewest n-tiles a warp >= ceil(Cp / 8 / NG),
// with the program staged or read in place
template <class T>
static int launch(const void* x, const void* program, const void* positions,
                  const void* v, const void* csq, void* labels, void* score,
                  int n, int E, int Dp, int M, int Cp, int MB, int ctas,
                  int staged, void* stream) {
  const int ntw = (Cp / 8 + NG - 1) / NG;
  auto go = [&](auto tag) {
    constexpr int K = decltype(tag)::value;
    return staged ? launch_ntw<T, K, true>(x, program, positions, v, csq,
                                           labels, score, n, E, Dp, M, Cp,
                                           MB, ctas, stream)
                  : launch_ntw<T, K, false>(x, program, positions, v, csq,
                                            labels, score, n, E, Dp, M, Cp,
                                            MB, ctas, stream);
  };
  if (ntw <= 1) return go(std::integral_constant<int, 1>());
  if (ntw <= 2) return go(std::integral_constant<int, 2>());
  if (ntw <= 4) return go(std::integral_constant<int, 4>());
  return go(std::integral_constant<int, MAX_CP / 8 / NG>());
}

}  // namespace sk
}  // namespace rt

// x [n, Dp] (Dp: D padded to the 16-byte vector); program [E] int2 and
// positions [nch][mpos(M)] from kernels/sketch_assign.py gather_program
// for this dtype's chunk width; MB: buckets a chunk holds, ctas: the grid,
// staged: the program copied to shared memory (kernels/sketch_assign.py
// geometry)
extern "C" int rt_sketch_assign_f32(const void* x, const void* program,
                                    const void* positions, const void* v,
                                    const void* csq, void* labels,
                                    void* score, int n, int E, int Dp, int M,
                                    int Cp, int MB, int ctas, int staged,
                                    void* stream) {
  return rt::sk::launch<float>(x, program, positions, v, csq, labels, score,
                               n, E, Dp, M, Cp, MB, ctas, staged, stream);
}

extern "C" int rt_sketch_assign_bf16(const void* x, const void* program,
                                     const void* positions, const void* v,
                                     const void* csq, void* labels,
                                     void* score, int n, int E, int Dp,
                                     int M, int Cp, int MB, int ctas,
                                     int staged, void* stream) {
  return rt::sk::launch<__nv_bfloat16>(x, program, positions, v, csq,
                                       labels, score, n, E, Dp, M, Cp, MB,
                                       ctas, staged, stream);
}
