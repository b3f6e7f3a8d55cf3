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
//   2. pair_conv_kernel: the implicit GEMM of igemm_sm90.cuh on wgmma
//      (M = the output pixels, N = Co, depth 9*K; a block owns 128 pixels
//      of one pair and 256 output channels, one block an SM). Its halo of
//      hp is built once per 32-channel slice for all nine taps: c1a and
//      c1t of the next slice are copied by cp.async into a staging area
//      during the slice's first row of taps; during its last row each
//      thread adds its chunks in fp32, normalises with the pair's
//      statistics (held in shared memory), applies relu and rounds to bf16
//      once, into the other halo buffer, while the row's MMAs run; the
//      build needs no barrier of its own. The reflection lives in the
//      build (row -1 -> 1, column W -> W - 2). Every hp element is built
//      about (TR + 2)(TC + 2) / (TR TC) times per 256 output channels: 1.6
//      x 4 = 6.4 times at 32 x 32, K = Co = 1024, where one build per tap
//      would be 36.
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

constexpr int MIN_BLOCKS = 1;    // blocks per SM the registers are sized for

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
  bf16* sB = reinterpret_cast<bf16*>(smem);   // 2 x TAPS x BN x BK
  // two halos of hp x 32 channels
  bf16* sH = reinterpret_cast<bf16*>(smem + Conv::SMEM_B);
  uint4* sRawA = reinterpret_cast<uint4*>(sH + 2 * rc.hp * BK);  // hp x 4
  uint4* sRawT = sRawA + rc.hp * 4;
  float2* sStat = reinterpret_cast<float2*>(sRawT + rc.hp * 4);  // K

  const int tid = threadIdx.x;
  const int N = H * W;
  const int tiles = tiles_of(H, W);
  const int pair = blockIdx.y / tiles;
  const Place pl = place_of(rc, blockIdx.y % tiles, W);
  const int n0 = blockIdx.x * BN;
  const int s = pair / F;
  const int f = pair - s * F;
  const Conv conv{wgt, sB, sH, rc, n0, Co, K, (K + BK - 1) / BK};

  for (int i = tid; i < K; i += THREADS) sStat[i] = stats[(size_t)pair * K + i];

  const bf16* a_base = c1a + (size_t)s * N * K;
  const bf16* t_base = c1t + (size_t)f * N * K;

  // c1a and c1t chunks of the halo for slice cs, by cp.async (zeros past K)
  auto issue_raw = [&](int cs) {
    for (int e = tid; e < rc.hp * 4; e += THREADS) {
      const int c = cs * BK + (e & 3) * 8;
      const bool ok = c < K;
      const size_t off = halo_pixel(rc, pl, e >> 2, H, W) * K + c;
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

  // slice 0's halo before the loop; slice cs + 1's c1a/c1t chunks are
  // copied at the first row of taps of slice cs (slice 1's here) and built
  // during its last row, into the other halo buffer
  issue_raw(0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // slice 0's c1a/c1t chunks, and sStat
  build_halo(0);
  __syncthreads();  // halo 0 is whole; the staging is free
  if (conv.slices > 1) issue_raw(1);
  conv.issue_b(0);
  cp_async_commit();

  float acc[ACC];
  conv.loop(
      acc, pl.valid_rows,
      [&](int cs) {
        if (cs >= 1 && cs + 1 < conv.slices) issue_raw(cs + 1);
      },
      [&](int cs) {
        if (cs + 1 < conv.slices) build_halo(cs + 1);
      });

  bf16* obase = out + (size_t)pair * N * Co;
  const int t4 = tid & 3;
  for_each_row([&](int h, int m) {
    const int p = row_pixel(rc, pl, m, H, W);
    if (p < 0) return;
    bf16* row = obase + (size_t)p * Co + n0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      if (n0 + n < Co)
        *reinterpret_cast<__nv_bfloat162*>(row + n) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  });
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
    const size_t smem = 1024 + (size_t)Conv::SMEM_B +
                        (size_t)rc.hp * BK * 2 * 4 + (size_t)K * sizeof(float2);
    e = cudaFuncSetAttribute(pair_conv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch reports its own
      return (int)e;
    }
    const dim3 blocks((Co + BN - 1) / BN, S * F * tiles_of(H, W));
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
