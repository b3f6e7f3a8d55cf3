// Fused reflect-pad 3x3 conv -> instance norm (-> relu | + skip) for
// Hopper (sm_90a): the decoder ResNet blocks of the bf16 tail.
//
// Replaces the TPU kernel wacv23_tsnet_tpu/ops/pallas_conv.py: conv3x3_in
// (:90, _kernel :44, pallas_call :122), run twice per block by
// resblock_fused (:135). For x (B, H, W, C) in bf16 and w (Co, C, 3, 3):
//   y   = conv3x3(reflect_pad1(x), w)       fp32 sums of bf16 products
//   out = bf16(IN(y) [relu] [+ skip])       IN per (frame, channel) over
//         the H*W pixels, one-pass fp32 var = max(E[y^2] - E[y]^2, 0)
// No bias: a per-channel constant cancels in the instance norm.
//
// Its ideal bound is the tensor cores': 2 * B*H*W * 9C * Co flops, 0.155
// TFLOP at B=32, 32x32, C=Co=512: 0.156 ms at the H100's dense bf16 rate
// (989 TFLOP/s), against ~0.1 GB of inputs and output (0.03 ms).
//
// Design. The TPU kernel holds a whole frame's (1024, Co) fp32 accumulator
// (2 MB) in VMEM and normalises it before its single write. A Hopper
// block cannot hold that, so the reduction is split (design (b)):
//   1. conv_in_kernel: the implicit GEMM of igemm_sm90.cuh, M = B*H*W
//      output pixels, N = Co, depth 9*C. A block owns 128 pixels of one
//      frame and 128 output channels (8 warps of 64 x 32, two blocks per
//      SM); both operands arrive by cp.async. The A loader reads x at the
//      reflected pixel, so no padded tensor exists. The epilogue writes the
//      pre-norm y in fp32 and adds each column's sum and sum of squares
//      over the tile's pixels (warp shuffles, then one fp32 atomicAdd per
//      warp and channel) into a (2, B, Co) buffer the caller zeroed.
//   2. in_finish_kernel: per element, mean and rstd of its (frame,
//      channel) from those sums, (y - mean) * rstd, relu or + skip, one
//      bf16 rounding. The fp32 round trip of y costs ~0.13 GB at B=32.
// Rounding matches the TPU kernel: statistics in fp32 on the fp32 conv
// sums, the output rounded to bf16 once. The atomics add in no fixed
// order, so the statistics vary in their last bits from run to run.
// Pixels past H*W and channels past Co are masked; C and Co must be
// multiples of 8 (16-byte chunks), H and W at least 2 (reflect pad).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "igemm_sm90.cuh"

namespace {

using namespace igemm;

constexpr int BN = 128;          // output channels per block
constexpr int MIN_BLOCKS = 2;    // blocks per SM the registers are sized for
constexpr int WN = Tile<BN>::WN;
constexpr int NI = Tile<BN>::NI;
constexpr int SMEM_BYTES = Tile<BN>::SMEM_BYTES;

constexpr int FINISH_THREADS = 256;

// ---------------------------------------------------------------------------
// 1. The implicit GEMM; pre-norm y in fp32 and per-(frame, channel) sums.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) conv_in_kernel(
    const bf16* __restrict__ x,    // (B, H, W, C)
    const bf16* __restrict__ wgt,  // (Co, 9C): [n][(dy*3 + dx)*C + c]
    float* __restrict__ y,         // (B, H*W, Co)
    float* __restrict__ sums,      // (2, B, Co): sum, sum of squares
    int B, int H, int W, int C, int Co) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);   // STAGES x BM x BK
  bf16* sB = sA + STAGES * BM * BK;           // STAGES x BN x BK

  const int lane = threadIdx.x & 31;
  const int wn = (threadIdx.x >> 5) >> 1;  // warp column: WN channels

  const int N = H * W;
  const int tiles = (N + BM - 1) / BM;
  const int frame = blockIdx.y / tiles;
  const int p0 = (blockIdx.y % tiles) * BM;
  const int n0 = blockIdx.x * BN;
  const int KD = 9 * C;
  const int KT = (KD + BK - 1) / BK;

  const Slots sl = slots(threadIdx.x, p0, N, W);
  const bf16* x_base = x + (size_t)frame * N * C;

  auto issue = [&](int kt, int stage) {
    if (kt >= KT) return;
    const Tap tp = tap_of(kt * BK + sl.ch * 8, C);
    bf16* dA = sA + stage * BM * BK;
#pragma unroll
    for (int i = 0; i < A_PASSES; ++i) {
      const bool ok = tp.ok && sl.ok[i];
      const bf16* src = ok ? x_base + a_offset(sl, i, tp, H, W, C) : x;
      cp_async16(smem_addr(dA + swz(sl.row0 + i * ROWS_PER_PASS, sl.ch)), src,
                 ok);
    }
    load_b<BN>(sB + stage * BN * BK, wgt, sl, kt, n0, Co, KD);
  };
  auto finish = [](int, int) {};  // cp.async lands the A stage by itself

  Acc<BN> acc;
  main_loop<BN>(acc, sA, sB, KT, issue, finish);

  // pre-norm y, fp32 (rows past N hold zeros: their A rows were zero)
  float* ybase = y + (size_t)frame * N * Co;
  for_each_pair<BN>(acc, N - p0, Co - n0,
                    [&](int p, int n, float v0, float v1) {
                      *reinterpret_cast<float2*>(
                          ybase + (size_t)(p0 + p) * Co + n0 + n) =
                          make_float2(v0, v1);
                    });

  // column sums over the warp's 64 pixels: each thread holds 2 columns per
  // n8 tile over 16 rows; lanes with one lane % 4 share those columns
#pragma unroll
  for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float v0 = acc[mi][ni][j];
        const float v1 = acc[mi][ni][2 + j];
        sum += v0 + v1;
        sq = fmaf(v0, v0, fmaf(v1, v1, sq));
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      const int n = n0 + wn * WN + ni * 8 + (lane & 3) * 2 + j;
      if (lane < 4 && n < Co) {
        atomicAdd(sums + (size_t)frame * Co + n, sum);
        atomicAdd(sums + ((size_t)B + frame) * Co + n, sq);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. Normalise, relu or + skip, round to bf16 once; 4 channels a thread.
template <bool RELU, bool SKIP>
__global__ void __launch_bounds__(FINISH_THREADS) in_finish_kernel(
    const float* __restrict__ y,      // (B, N, Co)
    const float* __restrict__ sums,   // (2, B, Co)
    const bf16* __restrict__ skip,    // (B, N, Co) or null
    bf16* __restrict__ out,           // (B, N, Co)
    int B, int N, int Co, float eps) {
  const size_t total = (size_t)B * N * Co / 4;
  const float inv_n = 1.f / N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 4;
    const int n = (int)(e % Co);
    const size_t frame = e / ((size_t)N * Co);
    const float4 v = *reinterpret_cast<const float4*>(y + e);
    const float4 s = *reinterpret_cast<const float4*>(sums + frame * Co + n);
    const float4 q =
        *reinterpret_cast<const float4*>(sums + ((size_t)B + frame) * Co + n);
    const float vv[4] = {v.x, v.y, v.z, v.w};
    const float sv[4] = {s.x, s.y, s.z, s.w};
    const float qv[4] = {q.x, q.y, q.z, q.w};
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float mean = sv[j] * inv_n;
      // E[y^2]-E[y]^2 can cancel below 0 for a near-constant channel
      const float var = fmaxf(qv[j] * inv_n - mean * mean, 0.f);
      r[j] = (vv[j] - mean) * rsqrtf(var + eps);
      if (RELU) r[j] = fmaxf(r[j], 0.f);
    }
    if (SKIP) {
      const uint2 sk = *reinterpret_cast<const uint2*>(skip + e);
      const float2 s01 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sk.x));
      const float2 s23 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sk.y));
      r[0] += s01.x;
      r[1] += s01.y;
      r[2] += s23.x;
      r[3] += s23.y;
    }
    __nv_bfloat162 o01 = __floats2bfloat162_rn(r[0], r[1]);
    __nv_bfloat162 o23 = __floats2bfloat162_rn(r[2], r[3]);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&o01);
    packed.y = *reinterpret_cast<uint32_t*>(&o23);
    *reinterpret_cast<uint2*>(out + e) = packed;
  }
}

template <bool RELU, bool SKIP>
void launch_finish(const float* y, const float* sums, const bf16* skip,
                   bf16* out, int B, int N, int Co, float eps,
                   cudaStream_t st) {
  const size_t total = (size_t)B * N * Co / 4;
  const size_t want = (total + FINISH_THREADS - 1) / FINISH_THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  in_finish_kernel<RELU, SKIP><<<blocks, FINISH_THREADS, 0, st>>>(
      y, sums, skip, out, B, N, Co, eps);
}

}  // namespace

extern "C" {

// x (B, H, W, C), w (Co, 3, 3, C), skip (B, H, W, Co) or null, out
// (B, H, W, Co): contiguous bf16, 16-byte aligned. y: fp32 scratch of
// B*H*W*Co; sums: fp32 scratch of 2*B*Co, zeroed by the caller.
int tsnet_conv3x3_in(const void* x, const void* w, const void* skip, void* y,
                     void* sums, void* out, int B, int H, int W, int C, int Co,
                     int relu, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* fy = static_cast<float*>(y);
  float* fsums = static_cast<float*>(sums);
  const int N = H * W;

  cudaError_t e = cudaFuncSetAttribute(
      conv_in_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return (int)e;
  }
  const dim3 blocks((Co + BN - 1) / BN, B * ((N + BM - 1) / BM));
  conv_in_kernel<<<blocks, THREADS, SMEM_BYTES, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), fy, fsums, B,
      H, W, C, Co);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const bf16* sk = static_cast<const bf16*>(skip);
  bf16* o = static_cast<bf16*>(out);
  if (sk != nullptr) {
    if (relu)
      launch_finish<true, true>(fy, fsums, sk, o, B, N, Co, eps, st);
    else
      launch_finish<false, true>(fy, fsums, sk, o, B, N, Co, eps, st);
  } else {
    if (relu)
      launch_finish<true, false>(fy, fsums, sk, o, B, N, Co, eps, st);
    else
      launch_finish<false, false>(fy, fsums, sk, o, B, N, Co, eps, st);
  }
  return (int)cudaGetLastError();
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
