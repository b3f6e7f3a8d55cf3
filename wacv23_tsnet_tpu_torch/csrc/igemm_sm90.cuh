// The implicit-GEMM machinery of the port's bf16 reflect-padded 3x3 convs
// for Hopper (sm_90a): conv3x3_in.cu (K7) and fuse_pair_conv2.cu (K6).
//
// Both run the conv as a GEMM: M = the output pixels, N = the output
// channels, depth 9*C ordered (dy, dx, c), on Hopper's warpgroup MMA
// (wgmma.mma_async m64n256k16, bf16 operands, fp32 accumulators in
// registers). A block owns a rectangle of TR x TC = BM = 128 output pixels
// of one plane (TC = min(W, 128), TR = 128 / TC) and BN = 256 output
// channels: two warpgroups of 64 pixel rows each. Its depth loop
// (Conv::loop) runs over 32-channel slices, and within a slice over the
// three rows dy of taps:
//   - the halo: the reflect-padded input of the block's (TR + 2) x
//     (TC + 2) pixels for one slice, in shared memory (two buffers), filled
//     by the including file (K7 copies x by cp.async with the reflection
//     in the addresses; K6 builds its normalised pair sum). Each halo row
//     is BK = 32 channels, 64 bytes, four 16-byte chunks XOR-swizzled
//     (swz) so that ldmatrix is free of bank conflicts;
//   - A: each warp's 16 pixel rows of a tap are ldmatrix fragments from
//     the halo, by per-lane row addresses (the pixel's halo index plus
//     dy * (TC + 2) + dx); wgmma takes A from these registers;
//   - B, the weight repacked to (Co, 3, 3, C), streams through 48 KB
//     stages, one stage per (slice, dy), three taps of 256 x 32 each (K6
//     by cp.async, two stages; K7 by TMA multicast over its cluster,
//     three). Its 64-byte rows in the same swizzle are exactly wgmma's
//     K-major layout with the 64-byte swizzle (and TMA's), so the tensor
//     cores read B from shared memory by descriptor (8-row groups 512
//     bytes apart; the stages on a 1024-byte boundary). Six wgmma a step.
// The accumulators of thread (warp w, lane l) hold tile row
// 16 w + l / 4 + 8 h and column 8 j + 2 (l % 4) + e at acc[4 j + 2 h + e]
// (h, e in {0, 1}, j < 32): for_each_row hands them to an epilogue.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace igemm {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;        // output pixels per block (one plane)
constexpr int BN = 256;        // output channels per block
constexpr int BK = 32;         // channels per depth slice
constexpr int THREADS = 256;   // two warpgroups of 64 pixel rows
constexpr int ROWS_PER_PASS = THREADS / (BK / 8);   // 64 tile rows a pass
constexpr int B_PASSES = BN / ROWS_PER_PASS;
constexpr int TAPS = 3;          // taps per B stage: one row dy of the 3x3
constexpr int B_TAP = BN * BK;                    // bf16 of one tap's slice
constexpr int B_STAGE = TAPS * B_TAP;             // bf16 of one B stage
constexpr int ACC = BN / 2;      // fp32 accumulators a thread (64 x 256 / 128)

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

// wgmma.mma_async m64n256k16: d (the warpgroup's 64 x 256 fp32 tile, 128
// registers a thread) += a (bf16, K-major, from registers) b (from a
// shared-memory descriptor).
__device__ __forceinline__ void wgmma_rs(float (&d)[ACC],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The ordering wgmma needs: a fence before the first wgmma that reads
// registers or shared memory written since, a commit closing the issued
// group, a wait until it is done (before the accumulators, the A
// registers or the read B stage are touched again); and the proxy fence
// that makes cp.async's shared-memory writes visible to the tensor cores.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The descriptor of a K-major B operand at shared address addr: start
// address >> 4 (bits 0-13), leading offset 1 (unused with a swizzle whose
// rows hold the whole K slice), 8-row groups 512 bytes apart (bits 32-45,
// in 16-byte units), 64-byte swizzle (layout 2, bits 62-63).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(512 >> 4) << 32) | (2ull << 62);
}

// The output rectangle of a block: TR rows x TC columns of the plane.
struct Rect {
  int tc, tr, hc, hp;  // columns, rows, halo columns, halo pixels
};

__host__ __device__ __forceinline__ Rect rect_of(int W) {
  Rect r;
  r.tc = W < BM ? W : BM;
  r.tr = BM / r.tc;
  r.hc = r.tc + 2;
  r.hp = (r.tr + 2) * r.hc;
  return r;
}

__host__ __device__ __forceinline__ int tiles_of(int H, int W) {
  const Rect r = rect_of(W);
  return ((H + r.tr - 1) / r.tr) * ((W + r.tc - 1) / r.tc);
}

// Where a block sits: its tile's first row and column in the plane and
// its tile rows that are pixels (the rest repeat pixel 0 and are masked).
struct Place {
  int y0, x0, valid_rows;
};

__device__ __forceinline__ Place place_of(const Rect& rc, int tile, int W) {
  const int tiles_x = (W + rc.tc - 1) / rc.tc;
  Place p;
  p.y0 = (tile / tiles_x) * rc.tr;
  p.x0 = (tile % tiles_x) * rc.tc;
  p.valid_rows = rc.tr * rc.tc;
  return p;
}

// The pixel of halo pixel hp, reflected into the H x W plane; halo pixels
// that only masked outputs read (past a ragged edge) are clamped into it.
__device__ __forceinline__ size_t halo_pixel(const Rect& rc, const Place& pl,
                                             int hp, int H, int W) {
  const int hr = hp / rc.hc, hcol = hp - hr * rc.hc;
  const int yy = min(max(reflect(pl.y0 - 1 + hr, H), 0), H - 1);
  const int xx = min(max(reflect(pl.x0 - 1 + hcol, W), 0), W - 1);
  return (size_t)yy * W + xx;
}

// Tile row m's output pixel, or -1 where it is none (past the tile's
// pixels or the plane's ragged edge).
__device__ __forceinline__ int row_pixel(const Rect& rc, const Place& pl,
                                         int m, int H, int W) {
  if (m >= pl.valid_rows) return -1;
  const int r = m / rc.tc, c = m - r * rc.tc;
  if (pl.y0 + r >= H || pl.x0 + c >= W) return -1;
  return (pl.y0 + r) * W + pl.x0 + c;
}

// A row of taps (step kt = slice cs, row dy) on the tensor cores: the
// six A fragments of the warp's 16 pixel rows from halo (ldmatrix at hb,
// the lane's pixel's halo index), then six wgmma against the three taps of
// the B stage tB, committed as one group (not waited for).
__device__ __forceinline__ void mma_row(float (&acc)[ACC],
                                        uint32_t (&af)[TAPS * 2][4],
                                        const bf16* halo, const bf16* tB,
                                        int hb, int hc, int dy) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int it = 0; it < TAPS * 2; ++it) {
    const int dx = it >> 1, kk = it & 1;
    ldmatrix_x4(af[it], smem_addr(halo + swz(hb + (dy - 1) * hc + dx - 1,
                                             kk * 2 + (lane >> 4))));
  }
  wgmma_fence();
#pragma unroll
  for (int it = 0; it < TAPS * 2; ++it) {
    const int dx = it >> 1, kk = it & 1;
    wgmma_rs(acc, af[it], b_desc(smem_addr(tB + dx * B_TAP) + 32 * kk));
  }
  wgmma_commit();
}

// Each lane's ldmatrix row: the halo index of its pixel; warp w owns tile
// rows 16 w.. (warpgroup w / 4 rows 64 (w / 4)..).
__device__ __forceinline__ int halo_row(const Rect& rc, int valid_rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = 16 * warp + (lane & 15);
  const int r = m < valid_rows ? m / rc.tc : 0;
  const int c = m < valid_rows ? m - r * rc.tc : 0;
  return (r + 1) * rc.hc + c + 1;
}

// K6's depth loop over `slices` 32-channel slices of a C-channel input:
// acc (zeroed here) += the block's 128 x 256 tile of the conv, A from the
// halos sH (two buffers of rc.hp x 32 channels), B from two stages sB (on
// a 1024-byte boundary) filled by cp.async from wgt (Co, 9C) for output
// channels n0.. At step kt = (slice cs, row dy) the loop waits for its
// copies, passes a barrier (after which the other B stage and the other
// halo are free), issues step kt + 1's B stage, calls prefetch(cs) at
// dy = 0 (it may issue copies of its own; they join the step's cp.async
// group), runs the row's six wgmma, calls build(cs) at dy = 2 while they
// run, and waits for them. The halo of slice 0 must be issued (and
// committed, with B stage 0, which issue_b(0) loads) before the loop.
struct Conv {
  static constexpr int SMEM_B = 2 * B_STAGE * 2;  // bytes of the B stages

  const bf16* wgt;
  bf16* sB;
  const bf16* sH;
  Rect rc;
  int n0, Co, C, slices;

  __device__ __forceinline__ void issue_b(int kt) const {
    const int tid = threadIdx.x;
    const int b_row0 = tid >> 2, b_ch = tid & 3;
    const int cs = kt / TAPS, dy = kt - cs * TAPS;
    const int c = cs * BK + b_ch * 8;
    const int KD = 9 * C;
    bf16* dst = sB + (kt & 1) * B_STAGE;
#pragma unroll
    for (int dx = 0; dx < TAPS; ++dx) {
      const int k = (dy * 3 + dx) * C + c;
#pragma unroll
      for (int i = 0; i < B_PASSES; ++i) {
        const int r = b_row0 + i * ROWS_PER_PASS;
        const int n = n0 + r;
        const bool ok = n < Co && c < C;
        cp_async16(smem_addr(dst + dx * B_TAP + swz(r, b_ch)),
                   ok ? wgt + (size_t)n * KD + k : wgt, ok);
      }
    }
  }

  template <class Prefetch, class Build>
  __device__ __forceinline__ void loop(float (&acc)[ACC], int valid_rows,
                                       Prefetch prefetch, Build build) const {
    const int hb = halo_row(rc, valid_rows);
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

    const int KT = TAPS * slices;
    for (int kt = 0; kt < KT; ++kt) {
      const int cs = kt / TAPS, dy = kt - cs * TAPS;
      cp_async_wait<0>();   // this thread's copies of step kt (and more)
      fence_proxy_async();  // B is read by the tensor cores' async proxy
      __syncthreads();      // everyone's; the other B stage and the other
                            // halo are free
      if (kt + 1 < KT) issue_b(kt + 1);
      if (dy == 0) prefetch(cs);
      cp_async_commit();
      uint32_t af[TAPS * 2][4];
      mma_row(acc, af, sH + (cs & 1) * rc.hp * BK, sB + (kt & 1) * B_STAGE,
              hb, rc.hc, dy);
      if (dy == TAPS - 1) build(cs);
      wgmma_wait0();
    }
    cp_async_wait<0>();
  }
};

// f(h, j, m) for each of the thread's two tile rows (h) and 32 column
// groups (j): m is the tile row, and acc[4 j + 2 h], acc[4 j + 2 h + 1]
// hold its columns 8 j + 2 (lane % 4) and the next.
template <class F>
__device__ __forceinline__ void for_each_row(F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h < 2; ++h) f(h, 16 * warp + (lane >> 2) + 8 * h);
}

}  // namespace igemm
