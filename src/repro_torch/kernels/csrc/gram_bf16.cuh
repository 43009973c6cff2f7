// The bf16 Gram-tile product of the port's wgmma bodies: the landmark
// tiles of assign_bf16.cuh and the bf16 tile body of kernel_matrix.cu
// both build their tiles here, so there is one product loop.
//
// A tile is X . Y^T over BM = 128 rows of X [M, D] and BN = 128 rows of Y
// [N, D]. A CTA of two warpgroups (64 rows each) walks a contiguous range
// [ib, ie) of tiles in row-major (row block, column tile) order: tile u
// covers rows (u / tn) BM and columns (u % tn) BN, tn = ceil(N / BN). Its
// (tile, chunk) steps, D in chunks of KC = 64 features (one 128-byte row
// of bf16), form one sequence through a ring of NSTAGE stages; each stage
// is X [128 rows, 64] and Y [128 rows, 64] loaded by TMA with 128-byte
// swizzle (rows past M or N and features past D zero-filled by TMA's
// bounds), counted on a `full` mbarrier. Thread 0 issues the loads; a
// stage is reloaded once all eight warps have arrived on its `empty`
// mbarrier, NSTAGE - 1 steps ahead of the products, so the next tile's
// first chunks load while the caller's epilogue of this tile runs.
//
// Per step a warpgroup issues four wgmma m64n128k16 (both operands K-major
// in shared memory, the layout X . Y^T has) into its 64 accumulators a
// thread, commits them, and waits only for the previous step's group, so
// one group is always queued on the tensor cores while the next stage's
// barrier is awaited. acc[4 j + e] of lane (g, t) of warp w is row 64 (w
// / 4) + 16 (w % 4) + g + 8 (e >> 1), column 8 j + 2 t + (e & 1) of the
// tile: the mma.sync C-fragment layout.
#pragma once

#include "hopper.cuh"

namespace rt {
namespace gb {

using namespace rt::hop;

constexpr int NT = 256;                       // two warpgroups
constexpr int NWARPS = NT / 32;
constexpr int BM = 128;                       // tile rows, 64 a warpgroup
constexpr int BN = 128;                       // tile columns
constexpr int KC = 64;                        // features per ring step
constexpr int NSTAGE = 3;
constexpr uint32_t X_BYTES = BM * KC * 2;     // one stage of X
constexpr uint32_t Y_BYTES = BN * KC * 2;     // one stage of Y
constexpr uint32_t STAGE_BYTES = X_BYTES + Y_BYTES;
constexpr uint32_t RING_BYTES = NSTAGE * STAGE_BYTES;
constexpr uint32_t BAR_BYTES = 16 * NSTAGE;   // the 2 NSTAGE mbarriers

// The tensor maps of X and Y are handed to each call that may load
// rather than kept in the ring: their addresses (kernel parameters) cost
// no registers across the caller's epilogue. WALK: the range may cross
// row blocks (kernel_matrix's persistent grid); without it (assign's
// split, one row block) a step's coordinates take one division, as few
// registers as the product loop had before it was shared.
template <bool WALK>
struct Ring {
  uint32_t ring;                     // 1024-aligned shared address
  uint32_t bars;                     // 2 NSTAGE mbarriers
  int nc, nsteps;
  int u;                             // the next step to multiply
  // WALK: the first tile and the column tiles of a row block; else the
  // row block's first row and the range's first column tile
  int a, b;

  __device__ __forceinline__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8u * (NSTAGE + s);
  }

  // tiles [ib, ie) of the tn column tiles of each row block. Every thread
  // constructs it: the barriers are initialised (a __syncthreads) and the
  // first NSTAGE steps issued.
  __device__ __forceinline__ Ring(uint32_t ring_, uint32_t bars_,
                                  const CUtensorMap* mx,
                                  const CUtensorMap* my, int D, int tn,
                                  int ib, int ie)
      : ring(ring_), bars(bars_), nc((D + KC - 1) / KC),
        nsteps((ie - ib) * nc), u(0), a(WALK ? ib : ib / tn * BM),
        b(WALK ? tn : ib % tn) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < NSTAGE; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), NWARPS);   // one arrival per warp
      }
      fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      tma_prefetch(mx);
      tma_prefetch(my);
      for (int s = 0; s < NSTAGE && s < nsteps; ++s) issue(s, mx, my);
    }
    __syncwarp();
  }

  // step s: the rows of its tile at features (s % nc) KC, into stage
  // s % NSTAGE
  __device__ __forceinline__ void issue(int s, const CUtensorMap* mx,
                                        const CUtensorMap* my) const {
    const int st = s % NSTAGE;
    const uint32_t dst = ring + st * STAGE_BYTES;
    const int q = s / nc, k0 = (s - q * nc) * KC;
    int row, col;
    if (WALK) {
      row = (a + q) / b * BM;
      col = (a + q) % b * BN;
    } else {
      row = a;
      col = (b + q) * BN;
    }
    mbar_expect_tx(full(st), STAGE_BYTES);
    tma_load_2d(dst, mx, full(st), k0, row);
    tma_load_2d(dst + X_BYTES, my, full(st), k0, col);
  }

  // step s's products have completed in this warp: once every warp says
  // so, thread 0 reloads its stage with step s + NSTAGE
  __device__ __forceinline__ void release(int s, const CUtensorMap* mx,
                                          const CUtensorMap* my) const {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s % NSTAGE));
    if (threadIdx.x == 0 && s + NSTAGE < nsteps) {
      mbar_wait(empty(s % NSTAGE), (s / NSTAGE) & 1);
      issue(s + NSTAGE, mx, my);
    }
    __syncwarp();
  }

  // acc = the next tile of the range (all D chunks); every thread calls it
  __device__ __forceinline__ void product(float (&acc)[BN / 2],
                                          const CUtensorMap* mx,
                                          const CUtensorMap* my) {
    const uint32_t xoff = (threadIdx.x >> 7) * 64 * 128;   // the warpgroup's rows
    for (int c = 0; c < nc; ++c, ++u) {
      const int st = u % NSTAGE;
      mbar_wait(full(st), (u / NSTAGE) & 1);
      __syncwarp();   // converged for the .sync.aligned wgmma
      const uint32_t xs = ring + st * STAGE_BYTES + xoff;
      const uint32_t ys = ring + st * STAGE_BYTES + X_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)   // 16 features = 32 bytes
        wgmma_ss(acc, desc_sw128(xs + 32 * kk, 0), desc_sw128(ys + 32 * kk, 0),
                 c > 0 || kk > 0);
      wgmma_commit();
      if (c + 1 < nc) {
        wgmma_wait<1>();   // step u - 1 is done; step u stays queued
        if (c > 0) release(u - 1, mx, my);
      } else {
        wgmma_wait_all();
        if (c > 0) release(u - 1, mx, my);
        release(u, mx, my);
      }
    }
    fence_regs(acc);
  }
};

}  // namespace gb
}  // namespace rt
