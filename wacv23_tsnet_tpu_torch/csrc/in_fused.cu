// Fused instance norm (+ relu) with phase groups for Hopper (sm_90a).
//
// Replaces the TPU kernels of wacv23_tsnet_tpu/ops/pallas_norms.py:
// instance_norm_fused (:185), its statistics pass (_stats_kernel,
// pallas_call :206) and its normalise pass (_norm_kernel, :234). For x
// (B, N, C), N = H*W pixels with channels innermost (NHWC), f32 or bf16:
//   sum[b, c] = sum_p x[b, p, c],  sq[b, c] = sum_p x[b, p, c]^2   (fp32)
//   with G phase groups the C channels are (G, C/G) and the sums of the G
//   copies of a channel pool, over N*G values;
//   mean = sum / n, var = max(sq / n - mean^2, 0), rstd = rsqrt(var + eps)
//   out = (x - mean) * rstd, relu if asked, one rounding to x's type.
// The cluster path also has the two-pass form of the port's fp32
// instance_norm (ops/norms.py): mean = sum / n, then
// var = sum_p (x - mean)^2 / n from the values already on chip, the same
// normalise. One pass or two is the launcher's choice; the one-pass form
// is the TPU kernel's and keeps its bits.
//
// What bounds it: memory. The function reads x once and writes out once,
// a few flops per element: at (32, 128, 128, 256) and at (32, 256, 256,
// 64) that is 268 MB each way in bf16 (0.160 ms at 3.35 TB/s) and 537 MB
// in f32 (0.321 ms). A sample's plane (8.4 MB in bf16, 16.8 MB in f32
// there) does not fit on chip, but the statistics of a channel need only
// that channel and its G phase copies.
//
// Design, the cluster path (one launch, x read from device memory once).
// The unit of work is (sample b, slab of `slab` channels of each phase
// group) over all N pixels: `slab` is 64 bytes of channels (32 bf16, 16
// f32; 32 or 16 bytes where C/G does not allow 64), so a unit reads half
// a 128-byte line per group a pixel, N * G * 64 bytes in all (4 MiB at the
// shapes above). A 64-byte segment streams from DRAM at about 1.2 times
// the rate of a 32-byte one (a unit of 2 MiB). A thread-block cluster of
// up to 16 blocks takes a unit, each block a contiguous range of `rows`
// pixels (256 KiB at those shapes: REG = 12 chunks a thread, 48 KiB, in
// registers, the rest, 208 KiB, in shared memory):
// 1. each thread loads its own 16-byte chunks (one group's quarter of a
//    segment, every P-th pixel): the first REG into registers, the rest
//    by cp.async in STAGES commit groups, and sums them in pixel order in
//    fp32, each stage as it lands;
// 2. the warp's lanes that hold the same channels add up by a butterfly
//    (pooling the groups), the warps in order, and the cluster finishes
//    the statistics over distributed shared memory in rank order
//    (cluster_stats_sm90.cuh), so a call gives the same bits as the last;
//    no atomics, no partials in device memory;
// 3. each thread normalises its chunks (cstats::normed, relu in fp32, one
//    rounding) and stores them with a streaming hint.
// The two-pass form sums x alone in 1, finishes the mean over the cluster
// as in 2, then sums (x - mean)^2 over the chunks it holds and finishes
// that over the cluster too (a second DSMEM round, no second read of x).
// The units of one sample are neighbours in the grid, so the slabs of a
// pixel's row are read at about the same time. 16 blocks of 208 KiB of
// shared memory: 7 such clusters run at once on the H100 (112 SMs).
//
// The three-launch path, for what no cluster covers (a unit past 16
// blocks, C/G off the 16-byte chunks, x off a 16-byte boundary): it reads
// x twice.
// 1. Statistics: each block takes one sample, a slab of channels and one
//    of `splits` ranges of pixels, and writes its fp32 partial sums
//    (B, splits, 2, C); no atomics. A thread owns one V-channel chunk (16
//    bytes: 4 f32 or 8 bf16; V = 1 where C or the pointer does not allow
//    16-byte loads) and strides over pixels; the threads that share a
//    chunk combine in shared memory.
// 2. A small pass forms mean and rstd per (b, c) from the partials,
//    pooling the G groups (cstats::stats_of).
// 3. Normalise, with the same decomposition as 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_stats_sm90.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;     // 16-byte loads in flight per thread
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SLAB = 32;  // channels of a slab: 64 bytes of bf16
constexpr int MAX_CLUSTER = 16;
constexpr int STAGES = 8;     // cp.async groups a block's part comes in
constexpr int REG = 12;       // chunks a thread holds in registers

// ---------------------------------------------------------------------------
// The three-launch path.

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// 16 bytes of x as V = 16 / sizeof(T) floats, and back with one rounding
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& q, float* v) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
  __device__ static uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& q, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* v) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return q;
  }
};

// V elements of x at p (16 bytes' worth, or V = 1), as floats, and back
template <int V, typename T>
__device__ __forceinline__ void load_vec(const T* p, float* v) {
  if constexpr (V == Chunk<T>::V) {
    Chunk<T>::unpack(*reinterpret_cast<const uint4*>(p), v);
  } else {
    static_assert(V == 1, "16 bytes or one element");
    v[0] = to_f32(*p);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_vec(T* p, const float* v) {
  if constexpr (V == Chunk<T>::V) {
    *reinterpret_cast<uint4*>(p) = Chunk<T>::pack(v);
  } else {
    static_assert(V == 1, "16 bytes or one element");
    store_one(p, v[0]);
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
    float2* __restrict__ stats,         // (B, C): mean, rstd
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
  const float2 st = cstats::stats_of(s, sq, (float)N * (float)G, eps);
  for (int g = 0; g < G; ++g) stats[(size_t)b * C + g * cg + c] = st;
}

template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(THREADS) in_norm_kernel(
    const T* __restrict__ x, const float2* __restrict__ stats,
    T* __restrict__ out, int N, int C, int splits) {
  const Part q = part_of<V>(N, C, splits);
  if (q.chunk < 0) return;
  float2 st[V];
  const float2* sp = stats + (size_t)blockIdx.z * C + q.chunk * V;
#pragma unroll
  for (int j = 0; j < V; ++j) st[j] = sp[j];
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
      for (int j = 0; j < V; ++j) v[u][j] = cstats::normed(v[u][j], st[j], RELU);
      store_vec<V>(op + (size_t)(p + u * q.ppb) * C, v[u]);
    }
  }
  for (; p < q.p_end; p += q.ppb) {
    float v[V];
    load_vec<V>(xp + (size_t)p * C, v);
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = cstats::normed(v[j], st[j], RELU);
    store_vec<V>(op + (size_t)p * C, v);
  }
}

template <typename T, int V>
cudaError_t launch_three(const void* x, void* out, float* partial,
                         float2* stats, int B, int N, int C, int G,
                         int splits, bool relu, int phases, float eps,
                         cudaStream_t stream) {
  const int chunks = C / V;
  const dim3 blocks((chunks + THREADS - 1) / THREADS, splits, B);
  const T* xt = static_cast<const T*>(x);
  cudaError_t e;
  if (phases & 1) {
    in_stats_kernel<T, V><<<blocks, THREADS, 0, stream>>>(xt, partial, N, C,
                                                          splits);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (phases & 2) {
    const int cells = B * (C / G);
    in_finalize_kernel<<<(cells + THREADS - 1) / THREADS, THREADS, 0,
                         stream>>>(partial, stats, B, N, C, G, splits, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (phases & 4) {
    T* ot = static_cast<T*>(out);
    if (relu)
      in_norm_kernel<T, V, true><<<blocks, THREADS, 0, stream>>>(
          xt, stats, ot, N, C, splits);
    else
      in_norm_kernel<T, V, false><<<blocks, THREADS, 0, stream>>>(
          xt, stats, ot, N, C, splits);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// The cluster path.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void store_streaming(void* p, uint4 q) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(q.x), "r"(q.y), "r"(q.z), "r"(q.w)
               : "memory");
}

// The halves of a cluster barrier: a block arrives once it has read every
// partial it needs, and waits before it leaves (its partials must stay
// put until the whole cluster has read them).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Runs f(k) for each cp.async stage k once that stage has landed.
template <int K, typename F>
__device__ __forceinline__ void each_stage(F&& f) {
  if constexpr (K < STAGES) {
    cp_async_wait<STAGES - 1 - K>();
    f(K);
    each_stage<K + 1>(f);
  }
}

// blockIdx.x = unit * cluster + rank, unit = b * slabs + slab index: the
// units of a sample are neighbours in the grid. Block `rank` takes pixels
// [rank * rows, (rank + 1) * rows) of the unit. A pixel's chunks of the
// unit are S = G * hs slots (hs = slab / V chunks of each group's
// segment); thread t takes slot t % S of the pixels p0 = rank * rows +
// t / S, p0 + P, ... (P = THREADS / S); it keeps chunks 0 .. REG - 1 in
// registers and chunk i >= REG at held[(i - REG) * THREADS + t], so that
// it reads back only what it copied in.
template <typename T, bool RELU, bool TWO_PASS>
__global__ void __launch_bounds__(THREADS) in_fused_cluster_kernel(
    const T* __restrict__ x, T* __restrict__ out, int N, int C, int G,
    int slab, int rows, float eps) {
  constexpr int V = Chunk<T>::V;
  extern __shared__ __align__(16) uint4 held[];
  __shared__ float wred[WARPS][2][MAX_SLAB];
  __shared__ float part[2 * MAX_SLAB];
  __shared__ float2 st[MAX_SLAB];

  const int t = threadIdx.x;
  const int csize = (int)cooperative_groups::this_cluster().num_blocks();
  const int rank = (int)cstats::cluster_rank();
  const int unit = blockIdx.x / csize;
  const int cg = C / G, slabs = cg / slab;
  const int b = unit / slabs, j = unit - b * slabs;
  const int hs = slab / V;
  const int S = G * hs, P = THREADS / S;
  const int s = t % S, pl = t / S;
  const int g = s / hs, h = s - g * hs;
  const int p0 = rank * rows + pl;
  const int pend = min(N, (rank + 1) * rows);
  // this thread's chunks: pixels p0, p0 + P, ... below pend; past the
  // REG in registers, STAGES cp.async groups of `per`
  const int m = pl < P && p0 < pend ? (pend - p0 + P - 1) / P : 0;
  const int per = (max(m - REG, 0) + STAGES - 1) / STAGES;
  const size_t off =
      ((size_t)b * N + p0) * C + g * cg + j * slab + h * V;
  const size_t step = (size_t)P * C;

  // 1. the chunks in: REG into registers, the rest staged into shared
  // memory; sum them in pixel order, each stage as it lands
  uint4 reg[REG];
#pragma unroll
  for (int i = 0; i < REG; ++i)
    if (i < m) reg[i] = __ldcs(reinterpret_cast<const uint4*>(x + off + i * step));
  for (int k = 0; k < STAGES; ++k) {
    for (int i = REG + k * per; i < min(m, REG + (k + 1) * per); ++i)
      cp_async16(smem_addr(&held[(i - REG) * THREADS + t]), x + off + i * step);
    cp_async_commit();
  }
  float sum[V], sq[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    sum[c] = 0.f;
    sq[c] = 0.f;
  }
  auto add = [&](const uint4& q) {
    float v[V];
    Chunk<T>::unpack(q, v);
#pragma unroll
    for (int c = 0; c < V; ++c) {
      sum[c] += v[c];
      if constexpr (!TWO_PASS) sq[c] = fmaf(v[c], v[c], sq[c]);
    }
  };
#pragma unroll
  for (int i = 0; i < REG; ++i)
    if (i < m) add(reg[i]);
  each_stage<0>([&](int k) {
    for (int i = REG + k * per; i < min(m, REG + (k + 1) * per); ++i)
      add(held[(i - REG) * THREADS + t]);
  });

  // 2. the lanes with the same chunk of the slab (lane % hs; hs is 1, 2
  // or 4, and pools the groups) add up, then the warps in order, then the
  // cluster's blocks in rank order
  const int lane = t % 32, warp = t / 32;
  const float count = (float)N * (float)G;
  if constexpr (!TWO_PASS) {
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) {
      if (o < hs) break;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], o);
        sq[c] += __shfl_xor_sync(0xffffffffu, sq[c], o);
      }
    }
    if (lane < hs) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        wred[warp][0][lane * V + c] = sum[c];
        wred[warp][1][lane * V + c] = sq[c];
      }
    }
    __syncthreads();
    if (t < slab) {
      float a = 0.f, q = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        a += wred[w][0][t];
        q += wred[w][1][t];
      }
      part[t] = a;
      part[slab + t] = q;
    }
    cstats::cluster_sync();
    if (t < slab) st[t] = cstats::cluster_stats(part, slab, t, count, eps);
  } else {
    // v summed over the lanes, then the warps, into the block's partial
    // `out` (t < slab), then over the cluster's blocks
    auto total = [&](float (&v)[V], float* out) {
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        if (o < hs) break;
#pragma unroll
        for (int c = 0; c < V; ++c)
          v[c] += __shfl_xor_sync(0xffffffffu, v[c], o);
      }
      if (lane < hs) {
#pragma unroll
        for (int c = 0; c < V; ++c) wred[warp][0][lane * V + c] = v[c];
      }
      __syncthreads();
      if (t < slab) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) a += wred[w][0][t];
        out[t] = a;
      }
      cstats::cluster_sync();
      return t < slab ? cstats::cluster_total(out, t) : 0.f;
    };
    // the mean, then (x - mean)^2 summed over the chunks held on chip
    const float mean_t = total(sum, part) / count;
    if (t < slab) st[t].x = mean_t;
    __syncthreads();
    float mean[V];
#pragma unroll
    for (int c = 0; c < V; ++c) mean[c] = st[h * V + c].x;
    auto dev = [&](const uint4& q) {
      float v[V];
      Chunk<T>::unpack(q, v);
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float d = v[c] - mean[c];
        sq[c] = fmaf(d, d, sq[c]);
      }
    };
#pragma unroll
    for (int i = 0; i < REG; ++i)
      if (i < m) dev(reg[i]);
    for (int i = REG; i < m; ++i) dev(held[(i - REG) * THREADS + t]);
    const float var_t = total(sq, part + slab) / count;
    if (t < slab) st[t].y = rsqrtf(var_t + eps);
  }
  cluster_arrive();
  __syncthreads();

  // 3. normalise the held chunks, one rounding, streaming stores
  float2 mine[V];
#pragma unroll
  for (int c = 0; c < V; ++c) mine[c] = st[h * V + c];
  auto put = [&](int i, const uint4& q) {
    float v[V];
    Chunk<T>::unpack(q, v);
#pragma unroll
    for (int c = 0; c < V; ++c) v[c] = cstats::normed(v[c], mine[c], RELU);
    store_streaming(out + off + i * step, Chunk<T>::pack(v));
  };
#pragma unroll
  for (int i = 0; i < REG; ++i)
    if (i < m) put(i, reg[i]);
  for (int i = REG; i < m; ++i) put(i, held[(i - REG) * THREADS + t]);
  cluster_wait();
}

template <typename T>
auto cluster_kernel(bool relu, bool two_pass) {
  if (two_pass)
    return relu ? in_fused_cluster_kernel<T, true, true>
                : in_fused_cluster_kernel<T, false, true>;
  return relu ? in_fused_cluster_kernel<T, true, false>
              : in_fused_cluster_kernel<T, false, false>;
}

// The launch configuration of the cluster path, its attributes set.
template <typename T>
cudaError_t cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                           int units, int cluster, int smem, bool relu,
                           bool two_pass, cudaStream_t st) {
  auto kernel = cluster_kernel<T>(relu, two_pass);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch reports its own
    return e;
  }
  *cfg = {};
  cfg->gridDim = dim3(units * cluster);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Whether the cluster path takes this plan: `smem` holds a block's chunks.
bool cluster_plan_ok(int B, int N, int C, int G, int slab, int cluster,
                     int rows, int smem, int V) {
  if (B < 1 || N < 1 || C < 1 || G < 1 || C % G || slab < V ||
      slab > MAX_SLAB || slab % V || (C / G) % slab || cluster < 1 ||
      cluster > MAX_CLUSTER || rows < 1 || (long long)rows * cluster < N ||
      (long long)B * (C / G / slab) * cluster > 0x7fffffff)
    return false;
  const int S = G * (slab / V);
  if (S > THREADS) return false;
  const long long chunks = (rows + THREADS / S - 1) / (THREADS / S);
  return (chunks - REG) * THREADS * 16 <= smem;
}

template <typename T>
cudaError_t launch_cluster(const void* x, void* out, int B, int N, int C,
                           int G, int slab, int cluster, int rows, int smem,
                           bool relu, bool two_pass, float eps,
                           cudaStream_t st) {
  if (!cluster_plan_ok(B, N, C, G, slab, cluster, rows, smem, Chunk<T>::V))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e = cluster_config<T>(&cfg, attr, B * (C / G / slab), cluster,
                                    smem, relu, two_pass, st);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, cluster_kernel<T>(relu, two_pass),
                         static_cast<const T*>(x), static_cast<T*>(out), N, C,
                         G, slab, rows, eps);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t max_clusters(int cluster, int smem, int* clusters) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cudaError_t e =
      cluster_config<T>(&cfg, attr, 1, cluster, smem, false, false, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(clusters,
                                       cluster_kernel<T>(false, false), &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return e;
}

}  // namespace

extern "C" {

// The cluster path: x and out (B, N, C), f32 or bf16 (in_bf16),
// contiguous, on 16-byte boundaries; C a multiple of G and C/G of `slab`
// (16 or 32 bytes of channels). A cluster of `cluster` blocks takes each
// (sample, slab) unit, each block `rows` pixels of it, held in `smem`
// bytes of dynamic shared memory. One launch; two_pass selects the
// two-pass statistics.
int tsnet_in_fused_cluster(const void* x, void* out, int B, int N, int C,
                           int G, int slab, int cluster, int rows, int smem,
                           int in_bf16, int relu, int two_pass, float eps,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16)
    return (int)launch_cluster<__nv_bfloat16>(x, out, B, N, C, G, slab,
                                              cluster, rows, smem, relu,
                                              two_pass, eps, st);
  return (int)launch_cluster<float>(x, out, B, N, C, G, slab, cluster, rows,
                                    smem, relu, two_pass, eps, st);
}

// How many clusters of the cluster path (cluster blocks, smem bytes of
// dynamic shared memory each) run at once on the current device
// (cudaOccupancyMaxActiveClusters), into *clusters.
int tsnet_in_fused_max_clusters(int cluster, int smem, int in_bf16,
                                int* clusters) {
  if (in_bf16)
    return (int)max_clusters<__nv_bfloat16>(cluster, smem, clusters);
  return (int)max_clusters<float>(cluster, smem, clusters);
}

// The three-launch path: x and out (B, N, C), f32 or bf16 (in_bf16),
// contiguous; partial (B, splits, 2, C) and stats (B, C) float2 scratch.
// vec is the channels a thread loads at a time: 16 bytes' worth (4 f32,
// 8 bf16), which needs C a multiple of it and x, out on 16-byte
// boundaries, or 1. C must be a multiple of G. `phases` selects the
// launches by bit (1 statistics, 2 finalize, 4 normalise; 7 all), so that
// each can be timed alone.
int tsnet_in_fused(const void* x, void* out, void* partial, void* stats,
                   int B, int N, int C, int G, int splits, int vec,
                   int in_bf16, int relu, int phases, float eps,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || C < 1 || G < 1 || C % G || splits < 1 ||
      C % vec || B > 65535 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  float* pt = static_cast<float*>(partial);
  float2* sp = static_cast<float2*>(stats);
  if (in_bf16) {
    if (vec == 8)
      return (int)launch_three<__nv_bfloat16, 8>(x, out, pt, sp, B, N, C, G,
                                                 splits, relu, phases, eps,
                                                 st);
    if (vec == 1)
      return (int)launch_three<__nv_bfloat16, 1>(x, out, pt, sp, B, N, C, G,
                                                 splits, relu, phases, eps,
                                                 st);
    return (int)cudaErrorInvalidValue;
  }
  if (vec == 4)
    return (int)launch_three<float, 4>(x, out, pt, sp, B, N, C, G, splits,
                                       relu, phases, eps, st);
  if (vec == 1)
    return (int)launch_three<float, 1>(x, out, pt, sp, B, N, C, G, splits,
                                       relu, phases, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
