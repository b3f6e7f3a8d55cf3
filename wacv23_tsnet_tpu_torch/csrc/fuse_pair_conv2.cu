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
// (0.09 ms at 3.35 TB/s). What limits this kernel is its A loader (below).
//
// Design. The TPU kernel builds the reflect-padded hp plane of a pair in
// VMEM (2.8 MB) and runs conv2 as three row dots. A Hopper block has at
// most 227 KB of shared memory, so hp is never materialised at all:
//   1. pair_stats_kernel: fp32 mean and rstd per (pair, channel) from c1a
//      and c1t (one block per frame and 32 channels; c1a stays in L2).
//   2. pair_conv_kernel: the implicit GEMM of igemm_sm90.cuh, M = S*F*H*W
//      output pixels, N = Co, depth 9*K. A block owns 128 pixels of one
//      pair and 256 output channels (8 warps of 64 x 64; one block per SM,
//      at ~230 registers a thread). Its A loader builds hp on the fly: for
//      each pixel of the tile and each 8-channel chunk of the depth slice
//      it loads c1a and c1t at the reflected pixel, adds them in fp32,
//      normalises with the pair's statistics (held in shared memory),
//      applies relu, rounds to bf16 and stores the chunk to shared memory.
//      The global loads for the next depth slice are issued before the
//      tensor-core work on the current one and converted after it. B is
//      the weight repacked to (Co, 3, 3, K), fed by cp.async. Every hp
//      element is built once per tap and per 256 output channels
//      (9 * Co/256 times in all): the loader's L2 traffic and its
//      conversion work, not the tensor cores, bound this first version.
// Rounding matches the TPU kernel: hp in bf16, bf16 products with fp32
// accumulation, one bf16 rounding of the output. Pixels past H*W and
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
constexpr int SMEM_TILES = Tile<BN>::SMEM_BYTES;

constexpr int STAT_LANES = 32;   // channels per stats block
constexpr int STAT_WARPS = 8;

__device__ __forceinline__ float2 unpack(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---------------------------------------------------------------------------
// 1. Statistics of xb = c1a[s] + c1t[f] per (pair, channel): {mean, rstd}.
//    One block per frame and 32 channels; lane <-> channel, the 8 warps
//    stride over the pixels.
__global__ void __launch_bounds__(STAT_LANES* STAT_WARPS) pair_stats_kernel(
    const bf16* __restrict__ c1a,  // (S, N, K)
    const bf16* __restrict__ c1t,  // (F, N, K)
    float2* __restrict__ stats,    // (S*F, K)
    int S, int F, int N, int K, float eps) {
  __shared__ float part_sum[STAT_WARPS][STAT_LANES];
  __shared__ float part_sq[STAT_WARPS][STAT_LANES];
  const int lane = threadIdx.x % STAT_LANES;
  const int warp = threadIdx.x / STAT_LANES;
  const int c = blockIdx.x * STAT_LANES + lane;
  const bool c_ok = c < K;
  const int f = blockIdx.y;
  const bf16* tp = c1t + (size_t)f * N * K + c;
  for (int s = 0; s < S; ++s) {
    const bf16* ap = c1a + (size_t)s * N * K + c;
    float sum = 0.f, sq = 0.f;
    for (int p = warp; p < N; p += STAT_WARPS) {
      const float x = c_ok ? __bfloat162float(ap[(size_t)p * K]) +
                                 __bfloat162float(tp[(size_t)p * K])
                           : 0.f;
      sum += x;
      sq = fmaf(x, x, sq);
    }
    part_sum[warp][lane] = sum;
    part_sq[warp][lane] = sq;
    __syncthreads();
    if (warp == 0 && c_ok) {
      float ts = 0.f, tq = 0.f;
#pragma unroll
      for (int w = 0; w < STAT_WARPS; ++w) {
        ts += part_sum[w][lane];
        tq += part_sq[w][lane];
      }
      const float mean = ts / N;
      // E[x^2]-E[x]^2 can cancel below 0 for a near-constant channel
      const float var = fmaxf(tq / N - mean * mean, 0.f);
      stats[((size_t)s * F + f) * K + c] = make_float2(mean, rsqrtf(var + eps));
    }
    __syncthreads();  // part_* are rewritten by the next source
  }
}

// ---------------------------------------------------------------------------
// 2. The implicit GEMM with hp built in the A loader.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) pair_conv_kernel(
    const bf16* __restrict__ c1a,      // (S, H, W, K)
    const bf16* __restrict__ c1t,      // (F, H, W, K)
    const bf16* __restrict__ wgt,      // (Co, 9K): [n][(dy*3 + dx)*K + k]
    const float2* __restrict__ stats,  // (S*F, K)
    bf16* __restrict__ out,            // (S*F, H*W, Co)
    int F, int H, int W, int K, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);        // STAGES x BM x BK
  bf16* sB = sA + STAGES * BM * BK;                // STAGES x BN x BK
  float2* sStat = reinterpret_cast<float2*>(smem + SMEM_TILES);  // K

  const int tid = threadIdx.x;
  const int N = H * W;
  const int tiles = (N + BM - 1) / BM;
  const int pair = blockIdx.y / tiles;
  const int p0 = (blockIdx.y % tiles) * BM;
  const int n0 = blockIdx.x * BN;
  const int s = pair / F;
  const int f = pair - s * F;
  const int KD = 9 * K;
  const int KT = (KD + BK - 1) / BK;

  for (int i = tid; i < K; i += THREADS) sStat[i] = stats[(size_t)pair * K + i];

  const Slots sl = slots(tid, p0, N, W);
  const bf16* a_base = c1a + (size_t)s * N * K;
  const bf16* t_base = c1t + (size_t)f * N * K;
  uint4 ra[A_PASSES], rt[A_PASSES];  // staged loads of the next A slice

  // issue: global loads of slice kt's c1a and c1t chunks to registers, the
  // weight by cp.async. No branch on kt: past the depth the loaders move
  // zeros, so the hp conversion in finish stays in the basic block of the
  // tensor-core work and interleaves with it.
  auto issue = [&](int kt, int stage) {
    const Tap tp = tap_of(kt * BK + sl.ch * 8, K);
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      if (tp.ok && sl.ok[i]) {
        const size_t off = a_offset(sl, i, tp, H, W, K);
        ra[i] = __ldg(reinterpret_cast<const uint4*>(a_base + off));
        rt[i] = __ldg(reinterpret_cast<const uint4*>(t_base + off));
      } else {
        ra[i] = make_uint4(0, 0, 0, 0);
        rt[i] = make_uint4(0, 0, 0, 0);
      }
    }
    load_b<BN>(sB + stage * BN * BK, wgt, sl, kt, n0, Co, KD);
  };

  // finish: hp = bf16(relu((a + t - mean) * rstd)) into the A stage
  auto finish = [&](int kt, int stage) {
    const Tap tp = tap_of(kt * BK + sl.ch * 8, K);
    bf16* dst = sA + stage * BM * BK;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      uint4 v = make_uint4(0, 0, 0, 0);
      if (tp.ok && sl.ok[i]) {
        const uint32_t av[4] = {ra[i].x, ra[i].y, ra[i].z, ra[i].w};
        const uint32_t tv[4] = {rt[i].x, rt[i].y, rt[i].z, rt[i].w};
        uint32_t hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 a = unpack(av[j]);
          const float2 t = unpack(tv[j]);
          // {mean, rstd} of channels c+2j and c+2j+1 in one 16-byte load
          const float4 st = reinterpret_cast<const float4*>(sStat)[tp.c / 2 + j];
          const float h0 = fmaxf((a.x + t.x - st.x) * st.y, 0.f);
          const float h1 = fmaxf((a.y + t.y - st.z) * st.w, 0.f);
          hv[j] = pack(h0, h1);
        }
        v = make_uint4(hv[0], hv[1], hv[2], hv[3]);
      }
      *reinterpret_cast<uint4*>(dst + swz(sl.row0 + i * ROWS_PER_PASS, sl.ch)) =
          v;
    }
  };

  __syncthreads();  // sStat is read by every thread's A loader

  Acc<BN> acc;
  main_loop<BN>(acc, sA, sB, KT, issue, finish);

  bf16* obase = out + (size_t)pair * N * Co;
  for_each_pair<BN>(acc, N - p0, Co - n0,
                    [&](int p, int n, float v0, float v1) {
                      *reinterpret_cast<__nv_bfloat162*>(
                          obase + (size_t)(p0 + p) * Co + n0 + n) =
                          __floats2bfloat162_rn(v0, v1);
                    });
}

}  // namespace

extern "C" {

// c1a (S, H, W, K), c1t (F, H, W, K), w (Co, 3, 3, K), out (S, F, H, W, Co):
// contiguous bf16, 16-byte aligned. stats: scratch of S*F*K float2.
int tsnet_fuse_pair_conv2(const void* c1a, const void* c1t, const void* w,
                          void* stats, void* out, int S, int F, int H, int W,
                          int K, int Co, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* a = static_cast<const bf16*>(c1a);
  const bf16* t = static_cast<const bf16*>(c1t);
  float2* fstats = static_cast<float2*>(stats);
  const int N = H * W;

  const dim3 sblocks((K + STAT_LANES - 1) / STAT_LANES, F);
  pair_stats_kernel<<<sblocks, STAT_LANES * STAT_WARPS, 0, st>>>(
      a, t, fstats, S, F, N, K, eps);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = (size_t)SMEM_TILES + (size_t)K * sizeof(float2);
  e = cudaFuncSetAttribute(pair_conv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return (int)e;
  }
  const dim3 blocks((Co + BN - 1) / BN, S * F * ((N + BM - 1) / BM));
  pair_conv_kernel<<<blocks, THREADS, smem, st>>>(
      a, t, static_cast<const bf16*>(w), fstats, static_cast<bf16*>(out), F, H,
      W, K, Co);
  return (int)cudaGetLastError();
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
