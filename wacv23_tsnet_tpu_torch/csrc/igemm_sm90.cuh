// Tile machinery shared by the port's bf16 tensor-core implicit GEMMs for
// Hopper (sm_90a): conv3x3_in.cu (K7) and fuse_pair_conv2.cu (K6).
//
// Both run a reflect-padded 3x3 conv over NHWC planes as a GEMM: M = the
// output pixels, N = the output channels, depth 9*C ordered (dy, dx, c).
// A block owns BM = 128 pixels of one plane and BN output channels; its 8
// warps sit 2 along M x 4 along N, each with a 64 x BN/4 warp tile of
// mma.sync m16n8k16 fragments (bf16 operands, fp32 accumulators). Each
// tile row is BK = 32 channels, 64 bytes, four 16-byte chunks
// XOR-swizzled so that ldmatrix and the 16-byte stores are free of bank
// conflicts. K7 runs main_loop: depth slices of BK through STAGES = 3
// shared-memory stages, the reflect pad in the index arithmetic (row
// -1 -> 1, row H -> H-2, the same for columns), the A loader and the
// epilogue supplied by the including file. K6 (fuse_pair_conv2.cu) takes
// the tile sizes, the swizzle (its B stages in this layout are wgmma's
// K-major 64-byte-swizzled operand), the copies and ldmatrix, and runs its
// own depth loop over a reflect-padded halo on wgmma.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace igemm {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // output pixels per block (one plane)
constexpr int BK = 32;         // depth per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 256;   // 8 warps: 2 along M x 4 along N
constexpr int WM = 64;         // warp tile rows
constexpr int MI = WM / 16;    // m16 tiles per warp
constexpr int ROWS_PER_PASS = THREADS / (BK / 8);   // 64 tile rows a pass
constexpr int A_PASSES = BM / ROWS_PER_PASS;         // 2

// The parts of the tiling that follow from BN, the block's channel width.
template <int BN>
struct Tile {
  static constexpr int WN = BN / 4;                    // warp tile columns
  static constexpr int NI = WN / 8;                    // n8 tiles per warp
  static constexpr int B_PASSES = BN / ROWS_PER_PASS;
  static constexpr int SMEM_BYTES = STAGES * (BM + BN) * BK * 2;
};

// Element offset of 16-byte chunk `chunk` (0..3) of tile row `row`; a row
// is BK bf16 = 64 bytes. The XOR spreads the 8 rows of an ldmatrix over
// all 32 banks.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * BK + ((chunk ^ ((row >> 1) & 3)) << 3);
}

__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int size = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A thread's loader slots: tile rows row0 + 64*i of 16-byte chunk ch, for
// tid = 4 * row0 + ch. The A slots know their pixel (py, px) in the plane.
struct Slots {
  int ch, row0;
  int py[A_PASSES], px[A_PASSES];
  bool ok[A_PASSES];   // pixel inside the plane
};

__device__ __forceinline__ Slots slots(int tid, int p0, int N, int W) {
  Slots s;
  s.ch = tid & 3;
  s.row0 = tid >> 2;
#pragma unroll
  for (int i = 0; i < A_PASSES; ++i) {
    const int p = p0 + s.row0 + i * ROWS_PER_PASS;
    s.ok[i] = p < N;
    s.py[i] = s.ok[i] ? p / W : 0;
    s.px[i] = s.ok[i] ? p - (p / W) * W : 0;
  }
  return s;
}

// The tap and channel of depth index k (a multiple of 8) for C channels.
struct Tap {
  bool ok;   // k inside the depth 9*C
  int dy, dx, c;
};

__device__ __forceinline__ Tap tap_of(int k, int C) {
  Tap t;
  t.ok = k < 9 * C;
  const int tap = t.ok ? k / C : 0;
  t.c = k - tap * C;
  t.dy = tap / 3 - 1;
  t.dx = tap % 3 - 1;
  return t;
}

// Element offset, in a (H, W, C) plane, of the A element a slot reads for
// a tap: the pixel shifted by (dy, dx) and reflected into the plane.
__device__ __forceinline__ size_t a_offset(const Slots& s, int i, const Tap& t,
                                           int H, int W, int C) {
  return ((size_t)reflect(s.py[i] + t.dy, H) * W + reflect(s.px[i] + t.dx, W)) *
             C +
         t.c;
}

// B stage: rows n0.. of the repacked weight (Co, 9C) at depth kt*BK, by
// cp.async; rows past Co and depth past 9C become zeros.
template <int BN>
__device__ __forceinline__ void load_b(bf16* dst, const bf16* wgt,
                                       const Slots& s, int kt, int n0, int Co,
                                       int KD) {
  const int k = kt * BK + s.ch * 8;
#pragma unroll
  for (int i = 0; i < Tile<BN>::B_PASSES; ++i) {
    const int r = s.row0 + i * ROWS_PER_PASS;
    const int n = n0 + r;
    const bool ok = n < Co && k < KD;
    const bf16* src = ok ? wgt + (size_t)n * KD + k : wgt;
    cp_async16(smem_addr(dst + swz(r, s.ch)), src, ok);
  }
}

template <int BN>
using Acc = float[MI][Tile<BN>::NI][4];

// The pipelined main loop over KT depth slices. issue(kt, stage) starts
// the loads of slice kt into a stage; finish(kt, stage) completes them
// after the tensor-core work on the current slice (a loader that converts
// its A elements loads them to registers in issue and stores them in
// finish, so the conversion overlaps the MMAs). issue must commit no
// cp.async group: the loop commits one per slice.
template <int BN, class Issue, class Finish>
__device__ __forceinline__ void main_loop(Acc<BN>& acc, const bf16* sA,
                                          const bf16* sB, int KT, Issue issue,
                                          Finish finish) {
  constexpr int NI = Tile<BN>::NI;
  constexpr int WN = Tile<BN>::WN;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;   // warp row: WM pixels
  const int wn = warp >> 1;  // warp column: WN channels

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < KT) {
      issue(st, st);
      finish(st, st);
    }
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // slice `next` goes to the stage of slice kt-1, which every thread is
    // done with: all passed the barrier above
    const int next = kt + STAGES - 1;
    issue(next, next % STAGES);
    cp_async_commit();

    const int stage = kt % STAGES;
    const bf16* tA = sA + stage * BM * BK;
    const bf16* tB = sB + stage * BN * BK;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[MI][4], bfr[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * WM + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], smem_addr(tA + swz(r, kk * 2 + (lane >> 4))));
      }
#pragma unroll
      for (int nj = 0; nj < NI / 2; ++nj) {
        const int r = wn * WN + nj * 16 + (lane & 7) + ((lane >> 4) << 3);
        uint32_t t4[4];
        ldmatrix_x4(t4, smem_addr(tB + swz(r, kk * 2 + ((lane >> 3) & 1))));
        bfr[2 * nj][0] = t4[0];
        bfr[2 * nj][1] = t4[1];
        bfr[2 * nj + 1][0] = t4[2];
        bfr[2 * nj + 1][1] = t4[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }

    finish(next, next % STAGES);
  }
  cp_async_wait<0>();
}

// Where the accumulators land: f(p, n, v0, v1) for each pixel p < rows
// and column pair n, n+1 with n < cols (both within the block's tile) that
// the thread holds. The bounds are checked per row, then per column pair:
// checking both for every pair ran K6 measurably slower on an H100.
template <int BN, class F>
__device__ __forceinline__ void for_each_pair(const Acc<BN>& acc, int rows,
                                              int cols, F f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = wm * WM + mi * 16 + (lane >> 2) + half * 8;
      if (p >= rows) continue;
#pragma unroll
      for (int ni = 0; ni < Tile<BN>::NI; ++ni) {
        const int n = wn * Tile<BN>::WN + ni * 8 + (lane & 3) * 2;
        if (n >= cols) continue;
        f(p, n, acc[mi][ni][2 * half], acc[mi][ni][2 * half + 1]);
      }
    }
  }
}

}  // namespace igemm
