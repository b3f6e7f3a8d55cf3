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
// (2 MB) in VMEM and normalises it before its single write. Here a block
// owns 128 pixels of one frame and 256 output channels, and runs the
// implicit GEMM of igemm_sm90.cuh on wgmma: a reflect-padded halo of its
// (TR + 2) x (TC + 2) pixels per 32-channel slice, a plain copy of x by
// cp.async with the reflection in the copy addresses (the next slice's
// copy runs during this slice's taps), feeds all nine taps. The weight
// slab (256 channels x 9C) is the same for every block of a cluster, so
// it streams through three 48 KB stages by TMA multicast: each block of
// the cluster loads an eighth of a stage's rows and multicasts it to all
// eight, against mbarriers (full: the stage's bytes have landed; empty:
// every warp of the group is done with it). The cluster reads the slab
// from L2 once, not eight times (0.15 GB a call at B=32, not 1.2 GB), and
// the stages are sent two steps ahead. The fp32 accumulators never leave
// registers before the norm:
//   - cluster path (a plane of at most 8 tiles: 8 at 32x32): the grid is
//     launched in clusters of the plane's tiles along the pixel axis. Each
//     block sums its columns over its valid pixels in a fixed order (its
//     two rows a thread, shuffles over the 8 lanes of a column, then the 8
//     warps in order), puts the sums in shared memory, and after a cluster
//     barrier reads all the cluster's sums over distributed shared memory
//     in rank order (cluster_stats_sm90.cuh): every block forms the same
//     mean and rstd, normalises its accumulators in registers, applies
//     relu or adds the skip and rounds to bf16 once into out. One launch,
//     no fp32 y, no atomics: two calls give the same bits;
//   - two-pass path (a larger plane): the same conv writes the pre-norm y
//     in fp32 and its per-tile sums; tile_stats_kernel sums them over the
//     tiles in order, in_finish_kernel normalises. The sums are taken in
//     the same order as on the cluster path (rank = tile), so the two
//     paths give the same bits.
// Rounding matches the TPU kernel: statistics in fp32 on the fp32 conv
// sums, the output rounded to bf16 once. Pixels past the plane and
// channels past Co are masked; C and Co must be multiples of 8 (16-byte
// chunks), H and W at least 2 (reflect pad).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_stats_sm90.cuh"
#include "igemm_sm90.cuh"

namespace {

using namespace igemm;

constexpr int MAX_CLUSTER = 8;   // the portable cluster size
constexpr int STAGES = 3;        // B stages
constexpr int SMEM_B = STAGES * B_STAGE * 2;   // bytes of the B stages
constexpr int FINISH_THREADS = 256;

// ---------------------------------------------------------------------------
// The weight stream: mbarriers and TMA multicast over the cluster.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// This thread arrives on bar and announces `bytes` to come by TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until bar's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Arrive on the barrier at bar's offset in block `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// The weight box at (k, n) of map into dst in every block of `mask`, each
// block's barrier at bar's offset counting its bytes.
__device__ __forceinline__ void tma_multicast(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, uint16_t mask,
                                              int k, int n) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(mask),
      "r"(k), "r"(n)
      : "memory");
}

// ---------------------------------------------------------------------------
// The conv and its statistics: on the cluster path also the norm.
template <bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1) conv_in_kernel(
    const __grid_constant__ CUtensorMap wmap,  // the weight (Co, 9C), bf16
    const bf16* __restrict__ x,     // (B, H, W, C)
    const bf16* __restrict__ skip,  // (B, H*W, Co) or null  (cluster path)
    bf16* __restrict__ out,         // (B, H*W, Co)          (cluster path)
    float* __restrict__ y,          // (B, H*W, Co) pre-norm (two-pass path)
    float* __restrict__ part,       // (B*tiles, 2, Co)      (two-pass path)
    int H, int W, int C, int Co, int group, int relu, float eps) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float cpart[2 * BN];   // the block's column sums and squares
  __shared__ float2 cstat[BN];      // {mean, rstd} of its columns
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const Rect rc = rect_of(W);
  // the B stages on a 1024-byte boundary (the swizzle's period)
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  bf16* sB = reinterpret_cast<bf16*>(smem);   // STAGES x TAPS x BN x BK
  bf16* sH = reinterpret_cast<bf16*>(smem + SMEM_B);  // 2 x hp x 32 ch.

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int N = H * W;
  const int tiles = tiles_of(H, W);
  const int frame = blockIdx.y / tiles;
  const Place pl = place_of(rc, blockIdx.y % tiles, W);
  const int n0 = blockIdx.x * BN;
  const int slices = (C + BK - 1) / BK;
  const int KT = TAPS * slices;
  const bf16* x_base = x + (size_t)frame * N * C;

  // The weight stream: the blocks of a multicast group (`group` blocks of
  // the cluster, rank-aligned) share each B stage; each loads 256 / group
  // of its rows for the three taps and multicasts them to the group. A
  // stage is full when its 48 KB have landed (full[s]) and free again when
  // all 8 warps of every block of the group are done with it (empty[s]).
  const unsigned rank = cstats::cluster_rank();
  const unsigned gbase = rank - rank % group;
  const uint16_t mask = (uint16_t)(((1u << group) - 1) << gbase);
  const int rows = BN / group;
  const int r0 = (int)(rank - gbase) * rows;
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8 * group);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cstats::cluster_sync();  // every block's barriers are set up

  auto produce = [&](int kt) {  // thread 0: step kt's B stage
    const int st = kt % STAGES, use = kt / STAGES;
    if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);  // step kt - 3's
    mbar_expect_tx(&full[st], B_STAGE * 2);
    const int cs = kt / TAPS, dy = kt - cs * TAPS;
    bf16* dst = sB + st * B_STAGE + r0 * BK;
#pragma unroll
    for (int dx = 0; dx < TAPS; ++dx)
      tma_multicast(dst + dx * B_TAP, &wmap, &full[st], mask,
                    (dy * 3 + dx) * C + cs * BK, n0 + r0);
  };
  auto release = [&](int kt) {  // this warp is done with step kt's stage
    if (lane < group) mbar_arrive_at(&empty[kt % STAGES], gbase + lane);
  };

  // slice cs of the halo: x at the reflected pixels, zeros past C
  auto issue_halo = [&](int cs) {
    bf16* halo = sH + (cs & 1) * rc.hp * BK;
    for (int e = tid; e < rc.hp * 4; e += THREADS) {
      const int hp = e >> 2, ch = e & 3, c = cs * BK + ch * 8;
      const bool ok = c < C;
      const bf16* src =
          ok ? x_base + halo_pixel(rc, pl, hp, H, W) * C + c : x_base;
      cp_async16(smem_addr(halo + swz(hp, ch)), src, ok);
    }
  };

  // The depth loop. At the first row of taps of slice cs the block waits
  // for slice cs's halo and passes a barrier (after which the other halo
  // is free) and issues slice cs + 1's halo; thread 0 sends step kt + 2's
  // B stage (its stage held step kt - 1, released at the end of step
  // kt - 1); every warp waits for step kt's stage, runs the row's six
  // wgmma, waits for them and releases the stage.
  issue_halo(0);
  cp_async_commit();
  if (tid == 0) {
    produce(0);
    if (KT > 1) produce(1);
  }
  const int hb = halo_row(rc, pl.valid_rows);
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < KT; ++kt) {
    const int cs = kt / TAPS, dy = kt - cs * TAPS;
    if (dy == 0) {
      cp_async_wait<0>();
      __syncthreads();
      if (cs + 1 < slices) issue_halo(cs + 1);
      cp_async_commit();
    }
    if (tid == 0 && kt + 2 < KT) produce(kt + 2);
    __syncwarp();  // warp 0 together again before its ldmatrix and wgmma
    mbar_wait(&full[kt % STAGES], (kt / STAGES) & 1);
    uint32_t af[TAPS * 2][4];
    mma_row(acc, af, sH + (cs & 1) * rc.hp * BK,
            sB + (kt % STAGES) * B_STAGE, hb, rc.hc, dy);
    wgmma_wait0();
    release(kt);
  }

  // the pixels of the thread's two tile rows (-1: none, masked)
  int pix[2];
  for_each_row([&](int h, int m) { pix[h] = row_pixel(rc, pl, m, H, W); });

  // column sums over the block's pixels, in a fixed order: the thread's
  // two rows, the 8 lanes that share a column (shuffles), the 8 warps
  float* wpart = reinterpret_cast<float*>(smem);  // [8 warps][2][BN]
  __syncthreads();  // every warp's wgmma is done with the B stages
  const int t4 = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float v0 = pix[0] >= 0 ? acc[4 * j + e] : 0.f;
      const float v1 = pix[1] >= 0 ? acc[4 * j + 2 + e] : 0.f;
      float sum = v0 + v1, sq = fmaf(v0, v0, v1 * v1);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sq += __shfl_xor_sync(0xffffffffu, sq, o);
      }
      if (lane < 4) {
        wpart[(2 * warp) * BN + 8 * j + 2 * t4 + e] = sum;
        wpart[(2 * warp + 1) * BN + 8 * j + 2 * t4 + e] = sq;
      }
    }
  }
  __syncthreads();
  {  // thread tid: column tid
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      sum += wpart[(2 * w) * BN + tid];
      sq += wpart[(2 * w + 1) * BN + tid];
    }
    cpart[tid] = sum;
    cpart[BN + tid] = sq;
  }

  if (!CLUSTER) {  // two-pass path: pre-norm y and the tile's sums
    if (n0 + tid < Co) {
      part[((size_t)blockIdx.y * 2) * Co + n0 + tid] = cpart[tid];
      part[((size_t)blockIdx.y * 2 + 1) * Co + n0 + tid] = cpart[BN + tid];
    }
    float* ybase = y + (size_t)frame * N * Co + n0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (pix[h] < 0) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = 8 * j + 2 * t4;
        if (n0 + n < Co)
          *reinterpret_cast<float2*>(ybase + (size_t)pix[h] * Co + n) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    return;
  }

  cstats::cluster_sync();  // every block's cpart is whole
  cstat[tid] = cstats::cluster_stats(cpart, BN, tid, (float)N, eps);
  cstats::cluster_sync();  // cstat is whole, and no block leaves while
                           // another still reads its cpart

  const size_t fbase = (size_t)frame * N * Co + n0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pix[h] < 0) continue;
    const size_t row = fbase + (size_t)pix[h] * Co;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = 8 * j + 2 * t4;
      if (n0 + n >= Co) continue;
      float r0 = cstats::normed(acc[4 * j + 2 * h], cstat[n], relu);
      float r1 = cstats::normed(acc[4 * j + 2 * h + 1], cstat[n + 1], relu);
      if (skip != nullptr) {
        const float2 sk = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(skip + row + n));
        r0 += sk.x;
        r1 += sk.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + row + n) =
          __floats2bfloat162_rn(r0, r1);
    }
  }
}

// ---------------------------------------------------------------------------
// Two-pass path, 2: {mean, rstd} per (frame, channel), the tiles' sums
// added in tile order.
__global__ void tile_stats_kernel(const float* __restrict__ part,  // (B*tiles, 2, Co)
                                  float2* __restrict__ stats,      // (B, Co)
                                  int B, int tiles, int N, int Co,
                                  float eps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * Co) return;
  const int frame = i / Co, n = i - frame * Co;
  float sum = 0.f, sq = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const size_t base = ((size_t)frame * tiles + t) * 2 * Co + n;
    sum += part[base];
    sq += part[base + Co];
  }
  stats[i] = cstats::stats_of(sum, sq, (float)N, eps);
}

// Two-pass path, 3: normalise, relu or + skip, round to bf16 once; 4
// channels a thread.
template <bool RELU, bool SKIP>
__global__ void __launch_bounds__(FINISH_THREADS) in_finish_kernel(
    const float* __restrict__ y,       // (B, N, Co)
    const float2* __restrict__ stats,  // (B, Co)
    const bf16* __restrict__ skip,     // (B, N, Co) or null
    bf16* __restrict__ out,            // (B, N, Co)
    int B, int N, int Co) {
  const size_t total = (size_t)B * N * Co / 4;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 4;
    const int n = (int)(e % Co);
    const size_t frame = e / ((size_t)N * Co);
    const float4 v = *reinterpret_cast<const float4*>(y + e);
    const float vv[4] = {v.x, v.y, v.z, v.w};
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = cstats::normed(vv[j], stats[frame * Co + n + j], RELU);
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
void launch_finish(const float* y, const float2* stats, const bf16* skip,
                   bf16* out, int B, int N, int Co, cudaStream_t st) {
  const size_t total = (size_t)B * N * Co / 4;
  const size_t want = (total + FINISH_THREADS - 1) / FINISH_THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  in_finish_kernel<RELU, SKIP><<<blocks, FINISH_THREADS, 0, st>>>(
      y, stats, skip, out, B, N, Co);
}

// Dynamic shared memory of the conv: alignment slack, the B stages, two
// halos.
size_t conv_smem(int W) {
  return 1024 + (size_t)SMEM_B + (size_t)rect_of(W).hp * BK * 2 * 2;
}

// The multicast group of a cluster of n blocks: the largest power of two
// dividing n (each member loads 256 / group of a stage's rows).
int group_of(int n) { return n & -n; }

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The weight (Co, 9C) as TMA sees it: boxes of 32 channels (64 bytes, the
// 64-byte swizzle of the stages) by `rows` rows; zeros past Co and past
// 9C. cuTensorMapEncodeTiled is looked up by its entry point at run time.
cudaError_t weight_map(CUtensorMap* map, const bf16* w, int C, int Co,
                       int rows) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
        cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      encode = nullptr;
      return e != cudaSuccess ? e : cudaErrorSymbolNotFound;
    }
  }
  const cuuint64_t dims[2] = {(cuuint64_t)9 * C, (cuuint64_t)Co};
  const cuuint64_t strides[1] = {(cuuint64_t)9 * C * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(w), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The launch of the conv kernel, in clusters of the plane's tiles on the
// cluster path.
template <bool CLUSTER>
cudaLaunchConfig_t conv_config(int B, int H, int W, int Co,
                               cudaLaunchAttribute* attr, cudaStream_t st) {
  const int tiles = tiles_of(H, W);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Co + BN - 1) / BN, B * tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = conv_smem(W);
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = CLUSTER ? tiles : 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool CLUSTER>
cudaError_t set_smem(int W) {
  cudaError_t e = cudaFuncSetAttribute(
      conv_in_kernel<CLUSTER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)conv_smem(W));
  if (e != cudaSuccess) cudaGetLastError();  // clear it
  return e;
}

}  // namespace

extern "C" {

// x (B, H, W, C), w (Co, 3, 3, C), skip (B, H, W, Co) or null, out
// (B, H, W, Co): contiguous bf16, 16-byte aligned. two_pass = 0: one
// launch in clusters of the plane's tiles (at most 8), for any nonzero
// `phases`. two_pass = 1: y,
// fp32 scratch of B*H*W*Co; part, of B*tiles*2*Co; stats, of B*Co
// float2; `phases` selects its launches by bit (1 conv, 2 statistics,
// 4 normalise; 7 all), so that each can be timed alone.
int tsnet_conv3x3_in(const void* x, const void* w, const void* skip,
                     void* out, void* y, void* part, void* stats, int B,
                     int H, int W, int C, int Co, int relu, float eps,
                     int two_pass, int phases, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const bf16* sk = static_cast<const bf16*>(skip);
  bf16* o = static_cast<bf16*>(out);
  float* fy = static_cast<float*>(y);
  float* fpart = static_cast<float*>(part);
  float2* fstats = static_cast<float2*>(stats);
  cudaLaunchAttribute attr[1];
  cudaError_t e;

  const int group = two_pass ? 1 : group_of(tiles_of(H, W));
  CUtensorMap wmap;
  if (!two_pass) {
    if (tiles_of(H, W) > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    if (phases == 0) return (int)cudaSuccess;
    if ((e = set_smem<true>(W)) != cudaSuccess) return (int)e;
    if ((e = weight_map(&wmap, wb, C, Co, BN / group)) != cudaSuccess)
      return (int)e;
    const cudaLaunchConfig_t cfg = conv_config<true>(B, H, W, Co, attr, st);
    e = cudaLaunchKernelEx(&cfg, conv_in_kernel<true>, wmap, xb, sk, o,
                           (float*)nullptr, (float*)nullptr, H, W, C, Co,
                           group, relu, eps);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }

  const int N = H * W;
  if (phases & 1) {
    if ((e = set_smem<false>(W)) != cudaSuccess) return (int)e;
    if ((e = weight_map(&wmap, wb, C, Co, BN / group)) != cudaSuccess)
      return (int)e;
    const cudaLaunchConfig_t cfg = conv_config<false>(B, H, W, Co, attr, st);
    e = cudaLaunchKernelEx(&cfg, conv_in_kernel<false>, wmap, xb,
                           (const bf16*)nullptr, (bf16*)nullptr, fy, fpart, H,
                           W, C, Co, group, relu, eps);
    if (e != cudaSuccess) return (int)e;
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (phases & 2) {
    tile_stats_kernel<<<(B * Co + 255) / 256, 256, 0, st>>>(
        fpart, fstats, B, tiles_of(H, W), N, Co, eps);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (phases & 4) {
    if (sk != nullptr) {
      if (relu)
        launch_finish<true, true>(fy, fstats, sk, o, B, N, Co, st);
      else
        launch_finish<false, true>(fy, fstats, sk, o, B, N, Co, st);
    } else {
      if (relu)
        launch_finish<true, false>(fy, fstats, sk, o, B, N, Co, st);
      else
        launch_finish<false, false>(fy, fstats, sk, o, B, N, Co, st);
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// How many clusters of the cluster path can run at once on the current
// device for this plane (cudaOccupancyMaxActiveClusters), into *clusters.
int tsnet_conv3x3_in_max_clusters(int H, int W, int Co, int* clusters) {
  cudaError_t e = set_smem<true>(W);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = conv_config<true>(1, H, W, Co, attr, 0);
  e = cudaOccupancyMaxActiveClusters(clusters, conv_in_kernel<true>, &cfg);
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
