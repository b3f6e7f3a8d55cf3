// Fused instance norm (+ relu) with phase groups for Hopper (sm_90a).
//
// Replaces the TPU kernels of wacv23_tsnet_tpu/ops/pallas_norms.py:
// instance_norm_fused, its statistics pass (_stats_kernel) and its
// normalise pass (_norm_kernel). For x (B, N, C), N = H*W pixels with
// channels innermost (NHWC), f32 or bf16:
//   sum[b, c] = sum_p x[b, p, c],  sq[b, c] = sum_p x[b, p, c]^2   (fp32)
//   with G phase groups the C channels are (G, C/G) and the sums of the G
//   copies of a channel pool, over N*G values;
//   mean = sum / n, var = max(sq / n - mean^2, 0), rstd = rsqrt(var + eps)
//   out = (x - mean) * rstd, relu if asked, one rounding to x's type.
//
// What bounds it: memory. The function reads x once and writes out once,
// a few flops per element: at (32, 128, 128, 256) bf16 that is 268 MB each
// way, 0.16 ms at 3.35 TB/s. This design reads x twice (statistics, then
// normalise), since a sample's plane (16 MB there) does not stay on chip.
//
// Design: three launches on one stream, one call of the wrapper.
// 1. Statistics. The TPU grid runs its pixel tiles in order and carries
//    the sums from one tile to the next; blocks here run in no order, so
//    each block takes one sample, a slab of channels and one of `splits`
//    ranges of pixels, and writes its fp32 partial sums (B, splits, 2, C);
//    no atomics, so the sums do not depend on the schedule. A thread owns
//    one V-channel chunk (16 bytes: 4 f32 or 8 bf16; V = 1 where C or the
//    pointer does not allow 16-byte loads) and strides over pixels; at
//    C = 64 bf16 eight threads cover a pixel and a warp four pixels, all
//    loads coalesced. The threads that share a chunk combine in shared
//    memory.
// 2. A small pass forms mean and rstd per (b, c) from the partials,
//    pooling the G groups.
// 3. Normalise, with the same decomposition; each thread keeps its
//    chunk's mean and rstd in registers, applies relu in fp32 and rounds
//    once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // 16-byte loads in flight per thread

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (V == 8) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  if constexpr (V == 8) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16(v[i]);
  }
}

// The part of x a block and a thread take: blockIdx (slab, split, b); a
// slab is up to THREADS chunks of V channels, and the block's threads
// cover `ppb` pixels of `cs` chunks at a time.
struct Part {
  int chunk;          // this thread's chunk, or -1 if it has none
  int p_begin;        // this thread's first pixel
  int p_end;          // one past the split's last pixel
  int ppb;            // pixel stride
  int cs;             // chunks in this slab
  size_t base;        // offset of (b, pixel 0, chunk) in elements
};

template <int V>
__device__ __forceinline__ Part part_of(int N, int C, int splits) {
  Part q;
  const int chunks = C / V;
  const int k0 = blockIdx.x * THREADS;
  q.cs = min(chunks - k0, THREADS);
  q.ppb = THREADS / q.cs;
  const int lane_px = threadIdx.x / q.cs;
  const int per = (N + splits - 1) / splits;
  const int split_begin = blockIdx.y * per;
  q.p_end = min(N, split_begin + per);
  q.p_begin = split_begin + lane_px;
  q.chunk = lane_px < q.ppb ? k0 + threadIdx.x % q.cs : -1;
  q.base = (size_t)blockIdx.z * N * C + (size_t)max(q.chunk, 0) * V;
  return q;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) in_stats_kernel(
    const T* __restrict__ x,        // (B, N, C)
    float* __restrict__ partial,    // (B, splits, 2, C)
    int N, int C, int splits) {
  __shared__ float red[2][V][THREADS];
  const Part q = part_of<V>(N, C, splits);
  float sum[V], sq[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    sum[j] = 0.f;
    sq[j] = 0.f;
  }
  if (q.chunk >= 0) {
    const T* xp = x + q.base;
    int p = q.p_begin;
    for (; p + (UNROLL - 1) * q.ppb < q.p_end; p += UNROLL * q.ppb) {
      float v[UNROLL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        load_vec<V>(xp + (size_t)(p + u * q.ppb) * C, v[u]);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          sum[j] += v[u][j];
          sq[j] = fmaf(v[u][j], v[u][j], sq[j]);
        }
    }
    for (; p < q.p_end; p += q.ppb) {
      float v[V];
      load_vec<V>(xp + (size_t)p * C, v);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sum[j] += v[j];
        sq[j] = fmaf(v[j], v[j], sq[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) {
    red[0][j][threadIdx.x] = sum[j];
    red[1][j][threadIdx.x] = sq[j];
  }
  __syncthreads();
  // thread o sums one (which, channel) of the slab over its ppb owners
  const int outs = q.cs * V;
  float* part = partial + ((size_t)blockIdx.z * splits + blockIdx.y) * 2 * C;
  const int c0 = blockIdx.x * THREADS * V;
  for (int o = threadIdx.x; o < 2 * outs; o += THREADS) {
    const int which = o / outs, rem = o % outs;
    const int j = rem % V, k = rem / V;
    float t = 0.f;
    for (int w = 0; w < q.ppb; ++w) t += red[which][j][w * q.cs + k];
    part[(size_t)which * C + c0 + k * V + j] = t;
  }
}

__global__ void __launch_bounds__(THREADS) in_finalize_kernel(
    const float* __restrict__ partial,  // (B, splits, 2, C)
    float* __restrict__ stats,          // (B, 2, C): mean, rstd
    int B, int N, int C, int G, int splits, float eps) {
  const int cg = C / G;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= B * cg) return;
  const int b = e / cg, c = e % cg;
  float s = 0.f, sq = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* part = partial + ((size_t)b * splits + sp) * 2 * C;
    for (int g = 0; g < G; ++g) {
      s += part[g * cg + c];
      sq += part[C + g * cg + c];
    }
  }
  const float n = (float)N * (float)G;
  const float mean = s / n;
  // E[x^2]-E[x]^2 can cancel below 0 for a near-constant channel
  const float var = fmaxf(sq / n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);
  for (int g = 0; g < G; ++g) {
    stats[(size_t)b * 2 * C + g * cg + c] = mean;
    stats[(size_t)b * 2 * C + C + g * cg + c] = rstd;
  }
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS) in_norm_kernel(
    const T* __restrict__ x, const float* __restrict__ stats,
    T* __restrict__ out, int N, int C, int splits) {
  const Part q = part_of<V>(N, C, splits);
  if (q.chunk < 0) return;
  float mean[V], rstd[V];
  const float* st = stats + (size_t)blockIdx.z * 2 * C + q.chunk * V;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    mean[j] = st[j];
    rstd[j] = st[C + j];
  }
  const T* xp = x + q.base;
  T* op = out + q.base;
  int p = q.p_begin;
  for (; p + (UNROLL - 1) * q.ppb < q.p_end; p += UNROLL * q.ppb) {
    float v[UNROLL][V];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      load_vec<V>(xp + (size_t)(p + u * q.ppb) * C, v[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float y = (v[u][j] - mean[j]) * rstd[j];
        v[u][j] = RELU ? fmaxf(y, 0.f) : y;
      }
      store_vec<V>(op + (size_t)(p + u * q.ppb) * C, v[u]);
    }
  }
  for (; p < q.p_end; p += q.ppb) {
    float v[V];
    load_vec<V>(xp + (size_t)p * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float y = (v[j] - mean[j]) * rstd[j];
      v[j] = RELU ? fmaxf(y, 0.f) : y;
    }
    store_vec<V>(op + (size_t)p * C, v);
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, void* out, float* partial, float* stats,
                   int B, int N, int C, int G, int splits, bool relu,
                   float eps, cudaStream_t stream) {
  const int chunks = C / V;
  const dim3 blocks((chunks + THREADS - 1) / THREADS, splits, B);
  const T* xt = static_cast<const T*>(x);
  in_stats_kernel<T, V><<<blocks, THREADS, 0, stream>>>(xt, partial, N, C,
                                                        splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int cells = B * (C / G);
  in_finalize_kernel<<<(cells + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      partial, stats, B, N, C, G, splits, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  T* ot = static_cast<T*>(out);
  if (relu)
    in_norm_kernel<T, V, true><<<blocks, THREADS, 0, stream>>>(xt, stats, ot,
                                                              N, C, splits);
  else
    in_norm_kernel<T, V, false><<<blocks, THREADS, 0, stream>>>(xt, stats, ot,
                                                               N, C, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x and out (B, N, C), f32 or bf16 (in_bf16), contiguous; partial
// (B, splits, 2, C) and stats (B, 2, C) f32 scratch. vec is the channels
// a thread loads at a time: 16 bytes' worth (4 f32, 8 bf16), which needs
// C a multiple of it and x, out on 16-byte boundaries, or 1. C must be a
// multiple of G.
int tsnet_in_fused(const void* x, void* out, void* partial, void* stats,
                   int B, int N, int C, int G, int splits, int vec,
                   int in_bf16, int relu, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || C < 1 || G < 1 || C % G || splits < 1 ||
      C % vec || B > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  float* pt = static_cast<float*>(partial);
  float* sp = static_cast<float*>(stats);
  if (in_bf16) {
    if (vec == 8)
      return (int)launch<__nv_bfloat16, 8>(x, out, pt, sp, B, N, C, G, splits,
                                           relu, eps, st);
    if (vec == 1)
      return (int)launch<__nv_bfloat16, 1>(x, out, pt, sp, B, N, C, G, splits,
                                           relu, eps, st);
    return (int)cudaErrorInvalidValue;
  }
  if (vec == 4)
    return (int)launch<float, 4>(x, out, pt, sp, B, N, C, G, splits, relu,
                                 eps, st);
  if (vec == 1)
    return (int)launch<float, 1>(x, out, pt, sp, B, N, C, G, splits, relu,
                                 eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
