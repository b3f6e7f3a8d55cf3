// Fused instance norm + mean over sources for Hopper (sm_90a).
//
// Replaces the TPU kernel wacv23_tsnet_tpu/ops/pallas_norms.py:
// instance_norm_mean (_in_mean_kernel): for x (S, F, N, C), N = H*W pixels
// with channels innermost (NHWC), out[f] = mean_s IN(x[s, f]) where IN is
// the per-channel instance norm over the N pixels with one-pass fp32
// statistics, var = max(E[x^2] - E[x]^2, 0), eps inside the rsqrt. The
// per-pair normalised tensor is never written.
//
// What bounds it: memory. It reads x once from device memory and writes
// the (F, N, C) mean once, a few flops per element: at S=3, N=1024,
// C=1024, bf16 that is 8.4 MB a frame, ~2.5 us a frame at 3.35 TB/s.
//
// Design: one block takes one frame and a slab of 32 channels; lane <->
// channel, so a warp reads 32 neighbouring channels of one pixel, and the
// 8 warps stride over the pixels. Per source the block reduces sum and
// sum of squares in fp32 registers, combines the 8 warps in shared memory,
// then normalises and adds into an fp32 accumulator of the whole slab
// (N x 32 floats, 128 KB at N=1024) held in shared memory. The second read
// of the plane is served mostly from L2 (the slab just read). After the
// last source it writes acc / S in the output type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;    // channels per block
constexpr int WARPS = 8;     // pixel stripes per block
constexpr int THREADS = LANES * WARPS;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename InT, typename OutT>
__global__ void __launch_bounds__(THREADS) in_mean_kernel(
    const InT* __restrict__ x,  // (S, F, N, C)
    OutT* __restrict__ out,     // (F, N, C)
    int S, int F, int N, int C, float eps) {
  extern __shared__ float acc[];  // (N, LANES)
  __shared__ float part_sum[WARPS][LANES];
  __shared__ float part_sq[WARPS][LANES];
  __shared__ float stat_mean[LANES];
  __shared__ float stat_rstd[LANES];

  const int lane = threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  const int c = blockIdx.x * LANES + lane;
  const bool c_ok = c < C;
  const int f = blockIdx.y;

  for (int s = 0; s < S; ++s) {
    const InT* xp = x + ((size_t)s * F + f) * N * C + c;
    float sum = 0.f, sq = 0.f;
    for (int p = warp; p < N; p += WARPS) {
      const float v = c_ok ? load(xp + (size_t)p * C) : 0.f;
      sum += v;
      sq = fmaf(v, v, sq);
    }
    part_sum[warp][lane] = sum;
    part_sq[warp][lane] = sq;
    __syncthreads();
    if (warp == 0) {
      float ts = 0.f, tq = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        ts += part_sum[w][lane];
        tq += part_sq[w][lane];
      }
      const float mean = ts / N;
      // E[x^2]-E[x]^2 can cancel below 0 for a near-constant channel
      const float var = fmaxf(tq / N - mean * mean, 0.f);
      stat_mean[lane] = mean;
      stat_rstd[lane] = rsqrtf(var + eps);
    }
    __syncthreads();
    const float mean = stat_mean[lane], rstd = stat_rstd[lane];
    for (int p = warp; p < N; p += WARPS) {
      const float v = c_ok ? load(xp + (size_t)p * C) : 0.f;
      const float y = (v - mean) * rstd;
      acc[p * LANES + lane] = s == 0 ? y : acc[p * LANES + lane] + y;
    }
    __syncthreads();  // part_* and stat_* are rewritten by the next source
  }
  if (!c_ok) return;
  for (int p = warp; p < N; p += WARPS)
    store(out + ((size_t)f * N + p) * C + c, acc[p * LANES + lane] / S);
}

template <typename InT, typename OutT>
cudaError_t launch(const void* x, void* out, int S, int F, int N, int C,
                   float eps, cudaStream_t stream) {
  auto kernel = in_mean_kernel<InT, OutT>;
  const size_t dyn = (size_t)N * LANES * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return e;
  }
  const dim3 blocks((C + LANES - 1) / LANES, F);
  kernel<<<blocks, THREADS, dyn, stream>>>(static_cast<const InT*>(x),
                                           static_cast<OutT*>(out), S, F, N,
                                           C, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (S, F, N, C) and out (F, N, C), each f32 or bf16 (the *_bf16 flags).
int tsnet_in_mean(const void* x, void* out, int S, int F, int N, int C,
                  int in_bf16, int out_bf16, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, out, S, F, N, C,
                                                       eps, st);
    return (int)launch<__nv_bfloat16, float>(x, out, S, F, N, C, eps, st);
  }
  if (out_bf16)
    return (int)launch<float, __nv_bfloat16>(x, out, S, F, N, C, eps, st);
  return (int)launch<float, float>(x, out, S, F, N, C, eps, st);
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
