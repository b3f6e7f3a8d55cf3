// Fused FuseNet pair block for Hopper (sm_90a): pair-sum -> instance norm
// -> relu -> reflect pad -> 3x3 conv2, for every (source, frame) pair.
//
// Replaces the TPU kernel wacv23_tsnet_tpu/ops/pallas_fuse.py:
// fuse_pair_conv2 (:96, _kernel :49, pallas_call :124). For c1a (S, H, W, K)
// and c1t (F, H, W, K) in bf16 and the conv2 weight w (Co, K, 3, 3):
//   xb[s, f]  = f32(c1a[s]) + f32(c1t[f])                    (H, W, K)
//   hp[s, f]  = bf16(relu((xb - mean) * rsqrt(var + eps)))
//               mean, var per (pair, channel) over the H*W pixels, one-pass
//               fp32 var = max(E[xb^2] - E[xb]^2, 0)
//   out[s, f] = bf16(conv3x3(reflect_pad1(hp[s, f]), w))     no bias
// The bias of conv2 is absent: the instance norm after it cancels it.
//
// Its ideal bound is the tensor cores': the conv is 2 * S*F*H*W * 9K * Co
// flops, 1.86 TFLOP at S=3, F=32, 32x32, K=Co=1024: 1.88 ms at the H100's
// dense bf16 rate (989 TFLOP/s), against ~0.29 GB of inputs and output
// (0.09 ms at 3.35 TB/s). Each block reads its 256 channels' slab of the
// weight (4.7 MB) from L2, 14.5 GB in all at that shape: beside the
// tensor cores, that L2 stream can set the pace.
//
// Design. The TPU kernel builds the reflect-padded hp plane of a pair in
// VMEM (2.8 MB) and runs conv2 as three row dots. A Hopper block has at
// most 227 KB of shared memory, so hp is never materialised whole:
//   1. pair_stats_kernel: fp32 mean and rstd per (pair, channel) from c1a
//      and c1t (one block per frame and 64 channels, each c1t element read
//      once for up to four sources; c1a stays in L2).
//   2. pair_conv_kernel: an implicit GEMM, M = the output pixels, N = Co,
//      depth 9*K, on Hopper's warpgroup MMA (wgmma.mma_async m64n256k16,
//      bf16 operands, fp32 accumulators in registers). A block owns a
//      rectangle of TR x TC output pixels of one pair (TC = min(W, 128),
//      TR = 128 / TC: 4 x 32 at W = 32; one part of a row where W > 128)
//      and 256 output channels: two warpgroups of 64 pixel rows each, one
//      block an SM. Its depth loop runs over 32-channel slices, and within
//      a slice over the three rows dy of taps:
//      - the halo: once per slice, the block builds the reflect-padded hp
//        of its (TR + 2) x (TC + 2) pixels into shared memory (13 KB at
//        W = 32; two buffers). c1a and c1t of the next slice are copied by
//        cp.async into a staging area while the tensor cores work on this
//        one; during the slice's last row of taps each thread adds its
//        chunks in fp32, normalises with the pair's statistics (held in
//        shared memory), applies relu and rounds to bf16 once, into the
//        other halo buffer, while the row's MMAs run; the build needs no
//        barrier of its own. The reflection lives in the build (row -1 ->
//        1, column W -> W - 2);
//      - A: each warp's 16 pixel rows of a tap are ldmatrix fragments from
//        the halo, by per-lane row addresses (the pixel's halo index plus
//        dy * (TC + 2) + dx); the halo rows are XOR-swizzled as the tiles
//        of igemm_sm90.cuh are, so the 16-byte reads are free of bank
//        conflicts. wgmma takes A from these registers;
//      - B, the weight repacked to (Co, 3, 3, K), streams through two
//        48 KB stages by cp.async, one stage per (slice, dy), three taps
//        of 256 x 32 each. Its 64-byte rows, XOR-swizzled by
//        igemm_sm90.cuh's swz, are exactly wgmma's K-major layout with
//        the 64-byte swizzle, so the tensor cores read B from shared
//        memory by descriptor (8-row groups 512 bytes apart; the stages on
//        a 1024-byte boundary). Six wgmma a step, one barrier a step.
//      Every hp element is built about (TR + 2)(TC + 2) / (TR TC) times per
//      256 output channels: 1.6 x 4 = 6.4 times at 32 x 32, K = Co = 1024,
//      where one build per tap would be 36.
// Rounding matches the TPU kernel: hp in bf16, bf16 products with fp32
// accumulation, one bf16 rounding of the output. Pixels past the plane and
// channels past Co are masked; K and Co must be multiples of 8 (16-byte
// chunks), H and W at least 2 (reflect pad).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "igemm_sm90.cuh"

namespace {

using namespace igemm;

constexpr int BN = 256;          // output channels per block
constexpr int MIN_BLOCKS = 1;    // blocks per SM the registers are sized for
constexpr int TAPS = 3;          // taps per B stage: one row dy of the 3x3
constexpr int B_STAGES = 2;
constexpr int B_TAP = BN * BK;                    // bf16 of one tap's slice
constexpr int B_STAGE = TAPS * B_TAP;             // bf16 of one B stage
constexpr int SMEM_B = B_STAGES * B_STAGE * 2;    // bytes of the B stages

constexpr int STAT_CH = 64;      // channels per stats block (2 a lane)
constexpr int STAT_WARPS = 8;
constexpr int STAT_S = 4;        // sources per pass over a frame
static_assert(STAT_S * STAT_CH == 32 * STAT_WARPS, "one thread a result");

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// wgmma.mma_async m64n256k16: d (the warpgroup's 64 x 256 fp32 tile, 128
// registers a thread) += a (bf16, K-major, from registers) b (from a
// shared-memory descriptor).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
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

// ---------------------------------------------------------------------------
// 1. Statistics of xb = c1a[s] + c1t[f] per (pair, channel): {mean, rstd}.
//    One block per frame and 64 channels, two channels a lane (one 4-byte
//    load); the 8 warps stride over the pixels, and each pass over the
//    frame's c1t serves up to STAT_S sources. Each warp sums its pixels in
//    order, then the warps are summed in order.
__global__ void __launch_bounds__(32 * STAT_WARPS) pair_stats_kernel(
    const bf16* __restrict__ c1a,  // (S, N, K)
    const bf16* __restrict__ c1t,  // (F, N, K)
    float2* __restrict__ stats,    // (S*F, K)
    int S, int F, int N, int K, float eps) {
  __shared__ float part[STAT_WARPS][STAT_S][2][STAT_CH];  // sums, squares
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * STAT_CH;
  const int c = c0 + 2 * lane;
  const bool c_ok = c < K;  // K % 8 == 0: so is c + 1
  const int f = blockIdx.y;
  const bf16* tp = c1t + (size_t)f * N * K + c;
  for (int s0 = 0; s0 < S; s0 += STAT_S) {
    float sum[STAT_S][2], sq[STAT_S][2];
#pragma unroll
    for (int j = 0; j < STAT_S; ++j)
      sum[j][0] = sum[j][1] = sq[j][0] = sq[j][1] = 0.f;
    if (c_ok) {
      for (int p = warp; p < N; p += STAT_WARPS) {
        const float2 t = unpack(*reinterpret_cast<const uint32_t*>(
            tp + (size_t)p * K));
#pragma unroll
        for (int j = 0; j < STAT_S; ++j) {
          if (s0 + j >= S) break;
          const float2 a = unpack(*reinterpret_cast<const uint32_t*>(
              c1a + ((size_t)(s0 + j) * N + p) * K + c));
          const float x0 = a.x + t.x, x1 = a.y + t.y;
          sum[j][0] += x0;
          sum[j][1] += x1;
          sq[j][0] = fmaf(x0, x0, sq[j][0]);
          sq[j][1] = fmaf(x1, x1, sq[j][1]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < STAT_S; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        part[warp][j][0][2 * lane + h] = sum[j][h];
        part[warp][j][1][2 * lane + h] = sq[j][h];
      }
    __syncthreads();
    {  // thread (source j, channel ch) of the pass
      const int j = threadIdx.x / STAT_CH, ch = threadIdx.x % STAT_CH;
      if (s0 + j < S && c0 + ch < K) {
        float ts = 0.f, tq = 0.f;
#pragma unroll
        for (int w = 0; w < STAT_WARPS; ++w) {
          ts += part[w][j][0][ch];
          tq += part[w][j][1][ch];
        }
        const float mean = ts / N;
        // E[x^2]-E[x]^2 can cancel below 0 for a near-constant channel
        const float var = fmaxf(tq / N - mean * mean, 0.f);
        stats[((size_t)(s0 + j) * F + f) * K + c0 + ch] =
            make_float2(mean, rsqrtf(var + eps));
      }
    }
    __syncthreads();  // part is rewritten by the next pass
  }
}

// ---------------------------------------------------------------------------
// 2. The implicit GEMM on wgmma, hp built once per 32-channel slice into a
//    halo.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) pair_conv_kernel(
    const bf16* __restrict__ c1a,      // (S, H, W, K)
    const bf16* __restrict__ c1t,      // (F, H, W, K)
    const bf16* __restrict__ wgt,      // (Co, 9K): [n][(dy*3 + dx)*K + k]
    const float2* __restrict__ stats,  // (S*F, K)
    bf16* __restrict__ out,            // (S*F, H*W, Co)
    int F, int H, int W, int K, int Co) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Rect rc = rect_of(W);
  // the B stages on a 1024-byte boundary (the swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sB = reinterpret_cast<bf16*>(smem);   // B_STAGES x TAPS x BN x BK
  bf16* sH = reinterpret_cast<bf16*>(smem + SMEM_B);  // 2 x hp x 32 channels
  uint4* sRawA = reinterpret_cast<uint4*>(sH + 2 * rc.hp * BK);  // hp x 4
  uint4* sRawT = sRawA + rc.hp * 4;
  float2* sStat = reinterpret_cast<float2*>(sRawT + rc.hp * 4);  // K

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = H * W;
  const int tiles_x = (W + rc.tc - 1) / rc.tc;
  const int tiles = ((H + rc.tr - 1) / rc.tr) * tiles_x;
  const int pair = blockIdx.y / tiles;
  const int tile = blockIdx.y % tiles;
  const int y0 = (tile / tiles_x) * rc.tr, x0 = (tile % tiles_x) * rc.tc;
  const int n0 = blockIdx.x * BN;
  const int s = pair / F;
  const int f = pair - s * F;
  const int slices = (K + BK - 1) / BK;
  const int KD = 9 * K;
  const int valid_rows = rc.tr * rc.tc;  // tile rows that are pixels

  for (int i = tid; i < K; i += THREADS) sStat[i] = stats[(size_t)pair * K + i];

  const bf16* a_base = c1a + (size_t)s * N * K;
  const bf16* t_base = c1t + (size_t)f * N * K;

  // c1a and c1t chunks of the halo for slice cs, by cp.async (zeros past K)
  auto issue_raw = [&](int cs) {
    for (int e = tid; e < rc.hp * 4; e += THREADS) {
      const int hp = e >> 2, c = cs * BK + (e & 3) * 8;
      const int hr = hp / rc.hc, hcol = hp - hr * rc.hc;
      // reflect into the plane; halo pixels that only masked outputs read
      // (past a ragged edge) are clamped into it
      const int yy = min(max(reflect(y0 - 1 + hr, H), 0), H - 1);
      const int xx = min(max(reflect(x0 - 1 + hcol, W), 0), W - 1);
      const bool ok = c < K;
      const size_t off = ((size_t)yy * W + xx) * K + c;
      cp_async16(smem_addr(sRawA + e), ok ? a_base + off : a_base, ok);
      cp_async16(smem_addr(sRawT + e), ok ? t_base + off : t_base, ok);
    }
  };

  // hp = bf16(relu((a + t - mean) * rstd)) of slice cs into halo cs % 2
  auto build_halo = [&](int cs) {
    bf16* halo = sH + (cs & 1) * rc.hp * BK;
    for (int e = tid; e < rc.hp * 4; e += THREADS) {
      const int hp = e >> 2, ch = e & 3, c = cs * BK + ch * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (c < K) {
        const uint4 ra = sRawA[e], rt = sRawT[e];
        const uint32_t av[4] = {ra.x, ra.y, ra.z, ra.w};
        const uint32_t tv[4] = {rt.x, rt.y, rt.z, rt.w};
        uint32_t hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = unpack(av[j]);
          const float2 t = unpack(tv[j]);
          // {mean, rstd} of channels c+2j and c+2j+1 in one 16-byte load
          const float4 st = reinterpret_cast<const float4*>(sStat)[c / 2 + j];
          const float h0 = fmaxf((a.x + t.x - st.x) * st.y, 0.f);
          const float h1 = fmaxf((a.y + t.y - st.z) * st.w, 0.f);
          hv[j] = pack(h0, h1);
        }
        v = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      }
      *reinterpret_cast<uint4*>(halo + swz(hp, ch)) = v;
    }
  };

  // B stage of step kt = (slice cs, row dy): rows n0.. of the weight at
  // depth (3 dy + dx) * K + cs * 32 for the three dx
  const int b_row0 = tid >> 2, b_ch = tid & 3;
  auto issue_b = [&](int kt) {
    const int cs = kt / TAPS, dy = kt - cs * TAPS;
    const int c = cs * BK + b_ch * 8;
    bf16* dst = sB + (kt & 1) * B_STAGE;
#pragma unroll
    for (int dx = 0; dx < TAPS; ++dx) {
      const int k = (dy * 3 + dx) * K + c;
#pragma unroll
      for (int i = 0; i < Tile<BN>::B_PASSES; ++i) {
        const int r = b_row0 + i * ROWS_PER_PASS;
        const int n = n0 + r;
        const bool ok = n < Co && c < K;
        cp_async16(smem_addr(dst + dx * B_TAP + swz(r, b_ch)),
                   ok ? wgt + (size_t)n * KD + k : wgt, ok);
      }
    }
  };

  // each lane's ldmatrix row: the halo index of its pixel; warp w owns
  // tile rows 16 w.. (warpgroup w / 4 rows 64 (w / 4)..)
  int hb;
  {
    const int m = 16 * warp + (lane & 15);
    const int r = m < valid_rows ? m / rc.tc : 0;
    const int c = m < valid_rows ? m - r * rc.tc : 0;
    hb = (r + 1) * rc.hc + c + 1;
  }
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  // slice 0's halo before the loop; slice cs + 1's is built during the
  // last row of taps of slice cs, into the other halo buffer
  issue_raw(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // slice 0's c1a/c1t chunks, and sStat
  build_halo(0);
  __syncthreads();  // halo 0 is whole; the staging is free
  if (slices > 1) issue_raw(1);
  issue_b(0);
  cp_async_commit();

  const int KT = TAPS * slices;
  for (int kt = 0; kt < KT; ++kt) {
    const int cs = kt / TAPS, dy = kt - cs * TAPS;
    cp_async_wait<0>();  // this thread's copies of step kt (and the raw)
    fence_proxy_async();  // B is read by the tensor cores' async proxy
    __syncthreads();     // everyone's; the other B stage, the other halo
                         // and (at dy = 0) the staging are free
    if (kt + 1 < KT) issue_b(kt + 1);
    if (dy == 0 && cs >= 1 && cs + 1 < slices) issue_raw(cs + 1);
    cp_async_commit();
    const bf16* tB = sB + (kt & 1) * B_STAGE;
    const bf16* halo = sH + (cs & 1) * rc.hp * BK;
    uint32_t af[TAPS * 2][4];
#pragma unroll
    for (int it = 0; it < TAPS * 2; ++it) {
      const int dx = it >> 1, kk = it & 1;
      ldmatrix_x4(af[it], smem_addr(halo + swz(hb + (dy - 1) * rc.hc + dx - 1,
                                               kk * 2 + (lane >> 4))));
    }
    wgmma_fence();
#pragma unroll
    for (int it = 0; it < TAPS * 2; ++it) {
      const int dx = it >> 1, kk = it & 1;
      wgmma_rs(acc, af[it], b_desc(smem_addr(tB + dx * B_TAP) + 32 * kk));
    }
    wgmma_commit();
    if (dy == TAPS - 1 && cs + 1 < slices) build_halo(cs + 1);
    wgmma_wait0();
  }
  cp_async_wait<0>();

  bf16* obase = out + (size_t)pair * N * Co;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = 16 * warp + g + 8 * h;
    if (p >= valid_rows) continue;
    const int r = p / rc.tc, c = p - r * rc.tc;
    if (y0 + r >= H || x0 + c >= W) continue;
    bf16* row = obase + ((size_t)(y0 + r) * W + x0 + c) * Co + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      if (n0 + n < Co)
        *reinterpret_cast<__nv_bfloat162*>(row + n) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

}  // namespace

extern "C" {

// c1a (S, H, W, K), c1t (F, H, W, K), w (Co, 3, 3, K), out (S, F, H, W, Co):
// contiguous bf16, 16-byte aligned. stats: scratch of S*F*K float2.
// `phases` selects the launches by bit (1 statistics, 2 conv; 3 both), so
// that each can be timed alone.
int tsnet_fuse_pair_conv2(const void* c1a, const void* c1t, const void* w,
                          void* stats, void* out, int S, int F, int H, int W,
                          int K, int Co, float eps, int phases, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(c1a);
  const bf16* t = static_cast<const bf16*>(c1t);
  float2* fstats = static_cast<float2*>(stats);
  const int N = H * W;
  cudaError_t e;

  if (phases & 1) {
    const dim3 sblocks((K + STAT_CH - 1) / STAT_CH, F);
    pair_stats_kernel<<<sblocks, 32 * STAT_WARPS, 0, st>>>(
        a, t, fstats, S, F, N, K, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (phases & 2) {
    const Rect rc = rect_of(W);
    // B stages, two halos, their c1a/c1t staging, statistics
    const size_t smem = 1024 + (size_t)SMEM_B + (size_t)rc.hp * BK * 2 * 4 +
                        (size_t)K * sizeof(float2);
    e = cudaFuncSetAttribute(pair_conv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch reports its own
      return (int)e;
    }
    const int tiles =
        ((H + rc.tr - 1) / rc.tr) * ((W + rc.tc - 1) / rc.tc);
    const dim3 blocks((Co + BN - 1) / BN, S * F * tiles);
    pair_conv_kernel<<<blocks, THREADS, smem, st>>>(
        a, t, static_cast<const bf16*>(w), fstats, static_cast<bf16*>(out),
        F, H, W, K, Co);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
