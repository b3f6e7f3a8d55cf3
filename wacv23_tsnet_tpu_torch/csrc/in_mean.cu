// Fused instance norm + mean over sources for Hopper (sm_90a).
//
// Replaces the TPU kernel wacv23_tsnet_tpu/ops/pallas_norms.py:
// instance_norm_mean (:99, _in_mean_kernel, pallas_call :135): for x
// (S, F, N, C), N = H*W pixels with channels innermost (NHWC),
// out[f] = mean_s IN(x[s, f]) where IN is the per-channel instance norm
// over the N pixels with one-pass fp32 statistics, var = max(E[x^2] -
// E[x]^2, 0), eps inside the rsqrt. The per-pair normalised tensor is
// never written.
//
// What bounds it: memory. It reads x once from device memory and writes
// the (F, N, C) mean once, a few flops per element: at S=3, F=32, N=1024,
// C=1024 that is 0.54 GB in f32 (0.160 ms at 3.35 TB/s) and 0.27 GB in
// bf16 (0.080 ms).
//
// Design. A block owns 128 pixels of one frame and 64 channels (a 256 B
// pixel row in f32, 128 B in bf16); a cluster of the frame's ceil(N / 128)
// blocks covers its pixels (8 at 32x32). Per source the block copies its
// tile into shared memory by cp.async 16-byte copies (or plain loads where
// C or the pointer rules them out), the next source's copy in flight while
// it works on this one. Each thread owns one channel of 32 pixels: it sums
// them in order, the block's four pixel groups are added in order, and
// after a cluster barrier every block reads the cluster's partials over
// distributed shared memory in rank order (cluster_stats_sm90.cuh). It then
// normalises its values from shared memory into fp32 accumulators in
// registers, summed over the sources, and after the last source writes
// acc / S once in the output type. So x is read from device memory once,
// and the occupancy is set by the tile (two buffers of 32 KB in f32),
// not by the plane. A plane of more than 8 tiles (past the portable
// cluster) takes two passes, which read x twice: plane_stats_kernel per
// (source, frame, channel), then the same tile kernel normalising with
// those statistics. No plane is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_stats_sm90.cuh"

namespace {

constexpr int TP = 128;             // pixels per block
constexpr int TCH = 64;             // channels per block
constexpr int GROUPS = 4;           // pixel groups: a thread per channel each
constexpr int THREADS = TCH * GROUPS;
constexpr int PER_THREAD = TP / GROUPS;   // pixels a thread
constexpr int MAX_CLUSTER = 8;      // the portable cluster size

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
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

// ---------------------------------------------------------------------------
// The tile kernel: statistics inside the cluster (CLUSTER), or from
// `stats` (the two-pass path's second pass).
template <typename InT, typename OutT, bool CLUSTER>
__global__ void __launch_bounds__(THREADS) in_mean_kernel(
    const InT* __restrict__ x,         // (S, F, N, C)
    OutT* __restrict__ out,            // (F, N, C)
    const float2* __restrict__ stats,  // (S, F, C) {mean, rstd}, two-pass
    int S, int F, int N, int C, int vec, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  InT* buf = reinterpret_cast<InT*>(smem);   // 2 x TP x TCH
  __shared__ float wpart[GROUPS][2][TCH];
  __shared__ float cpart[2][2 * TCH];        // per source parity
  __shared__ float2 cstat[TCH];

  const int tid = threadIdx.x;
  const int c = tid % TCH, pg = tid / TCH;
  const int c0 = blockIdx.x * TCH;
  const int tiles = (N + TP - 1) / TP;
  const int f = blockIdx.y / tiles;
  const int p0 = (blockIdx.y % tiles) * TP;
  const int rows = min(TP, N - p0);
  const bool c_ok = c0 + c < C;

  // source s's tile into buffer s % 2; zeros past the plane and past C
  auto issue = [&](int s) {
    InT* dst = buf + (s & 1) * TP * TCH;
    const InT* src = x + ((size_t)s * F + f) * N * C + (size_t)p0 * C + c0;
    if (vec) {
      constexpr int VE = 16 / sizeof(InT);   // elements a copy
      constexpr int ROW = TCH / VE;          // copies a pixel row
      for (int e = tid; e < TP * ROW; e += THREADS) {
        const int p = e / ROW, ch = (e - p * ROW) * VE;
        const bool ok = p < rows && c0 + ch < C;
        cp_async16(smem_addr(dst + p * TCH + ch),
                   ok ? src + (size_t)p * C + ch : src, ok);
      }
    } else {
      InT zero;
      store(&zero, 0.f);
      for (int e = tid; e < TP * TCH; e += THREADS) {
        const int p = e / TCH, ch = e - p * TCH;
        dst[e] = p < rows && c0 + ch < C ? src[(size_t)p * C + ch] : zero;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[PER_THREAD];
  issue(0);
  for (int s = 0; s < S; ++s) {
    if (s + 1 < S) {
      issue(s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // source s's tile is whole
    const InT* t = buf + (s & 1) * TP * TCH + c;

    float mean, rstd;
    if (CLUSTER) {
      float sum = 0.f, sq = 0.f;
#pragma unroll
      for (int i = 0; i < PER_THREAD; ++i) {
        const float v = to_f32(t[(pg + GROUPS * i) * TCH]);
        sum += v;
        sq = fmaf(v, v, sq);
      }
      wpart[pg][0][c] = sum;
      wpart[pg][1][c] = sq;
      __syncthreads();
      float* part = cpart[s & 1];
      if (tid < TCH) {
        float ts = 0.f, tq = 0.f;
#pragma unroll
        for (int g = 0; g < GROUPS; ++g) {
          ts += wpart[g][0][tid];
          tq += wpart[g][1][tid];
        }
        part[tid] = ts;
        part[TCH + tid] = tq;
      }
      // every block's partials of source s are whole; the other parity's
      // were read by everyone before it arrived here
      cstats::cluster_sync();
      if (tid < TCH)
        cstat[tid] = cstats::cluster_stats(part, TCH, tid, (float)N, eps);
      __syncthreads();
      mean = cstat[c].x;
      rstd = cstat[c].y;
    } else {
      const float2 st = c_ok ? stats[((size_t)s * F + f) * C + c0 + c]
                             : make_float2(0.f, 0.f);
      mean = st.x;
      rstd = st.y;
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const float y = cstats::normed(to_f32(t[(pg + GROUPS * i) * TCH]),
                                     make_float2(mean, rstd), false);
      acc[i] = s == 0 ? y : acc[i] + y;
    }
    __syncthreads();  // buffer s % 2 is free for source s + 2
  }
  // no block leaves while another still reads its partials
  if (CLUSTER) cstats::cluster_sync();
  if (!c_ok) return;
  OutT* o = out + ((size_t)f * N + p0) * C + c0 + c;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int p = pg + GROUPS * i;
    if (p < rows) store(o + (size_t)p * C, acc[i] / S);
  }
}

// ---------------------------------------------------------------------------
// The two-pass path's first pass: {mean, rstd} per (source, frame,
// channel); a block per plane and 64 channels, each thread one channel
// over every fourth pixel, the four groups added in order.
template <typename InT>
__global__ void __launch_bounds__(THREADS) plane_stats_kernel(
    const InT* __restrict__ x,   // (S*F, N, C)
    float2* __restrict__ stats,  // (S*F, C)
    int N, int C, float eps) {
  __shared__ float wpart[GROUPS][2][TCH];
  const int tid = threadIdx.x;
  const int c = tid % TCH, pg = tid / TCH;
  const int ch = blockIdx.x * TCH + c;
  const bool c_ok = ch < C;
  const InT* xp = x + (size_t)blockIdx.y * N * C + ch;
  float sum = 0.f, sq = 0.f;
  if (c_ok) {
    for (int p = pg; p < N; p += GROUPS) {
      const float v = to_f32(xp[(size_t)p * C]);
      sum += v;
      sq = fmaf(v, v, sq);
    }
  }
  wpart[pg][0][c] = sum;
  wpart[pg][1][c] = sq;
  __syncthreads();
  if (tid < TCH && c_ok) {
    float ts = 0.f, tq = 0.f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      ts += wpart[g][0][tid];
      tq += wpart[g][1][tid];
    }
    stats[(size_t)blockIdx.y * C + ch] =
        cstats::stats_of(ts, tq, (float)N, eps);
  }
}

template <typename InT, typename OutT>
cudaError_t launch(const void* x, void* out, void* stats, int S, int F,
                   int N, int C, int vec, int two_pass, int phases,
                   float eps, cudaStream_t st) {
  const int tiles = (N + TP - 1) / TP;
  const InT* xi = static_cast<const InT*>(x);
  OutT* o = static_cast<OutT*>(out);
  float2* fstats = static_cast<float2*>(stats);
  cudaError_t e;
  if (!two_pass && tiles > MAX_CLUSTER) return cudaErrorInvalidValue;
  if (phases == 0) return cudaSuccess;
  if (two_pass && (phases & 1)) {
    plane_stats_kernel<InT><<<dim3((C + TCH - 1) / TCH, S * F), THREADS,
                              0, st>>>(xi, fstats, N, C, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (two_pass && !(phases & 2)) return cudaSuccess;

  auto kernel = two_pass ? in_mean_kernel<InT, OutT, false>
                         : in_mean_kernel<InT, OutT, true>;
  const size_t dyn = 2 * TP * TCH * sizeof(InT);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)dyn);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((C + TCH - 1) / TCH, F * tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = two_pass ? 1 : tiles;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, xi, o, (const float2*)fstats, S, F, N,
                         C, vec, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (S, F, N, C) and out (F, N, C), each f32 or bf16 (the *_bf16 flags).
// vec: x starts on a 16-byte boundary and C is a multiple of 16 bytes'
// elements (16-byte copies). two_pass = 0: one launch in clusters of
// ceil(N / 128) blocks (at most 8), for any nonzero `phases`. two_pass = 1: stats, scratch of S*F*C
// float2; `phases` selects its launches by bit (1 statistics, 2
// normalise and mean; 3 both), so that each can be timed alone.
int tsnet_in_mean(const void* x, void* out, void* stats, int S, int F, int N,
                  int C, int in_bf16, int out_bf16, int vec, int two_pass,
                  int phases, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (in_bf16) {
    if (out_bf16)
      return (int)launch<bf16, bf16>(x, out, stats, S, F, N, C, vec, two_pass,
                                     phases, eps, st);
    return (int)launch<bf16, float>(x, out, stats, S, F, N, C, vec, two_pass,
                                    phases, eps, st);
  }
  if (out_bf16)
    return (int)launch<float, bf16>(x, out, stats, S, F, N, C, vec, two_pass,
                                    phases, eps, st);
  return (int)launch<float, float>(x, out, stats, S, F, N, C, vec, two_pass,
                                   phases, eps, st);
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
