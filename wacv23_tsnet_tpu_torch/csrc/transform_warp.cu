// Transformation branch of TS-Net for Hopper (sm_90a): masked temp-100
// similarity -> softmax -> coordinate flow -> bilinear warp, one kernel.
//
// Replaces the TPU kernels of wacv23_tsnet_tpu/ops/pallas_similarity.py:
//   MEAN = true : transform_warp_pairs_mean (_pairs_mean_pallas/_mean_kernel
//                 and _pairs_mean_bigt_pallas/_mean_bigt_kernel): the mean
//                 over sources of the warped features, (F, T, C) in f32 or
//                 bf16; the per-pair tensor is never written.
//   MEAN = false: _pairs_pallas/_pair_kernel, every (group, source, frame)
//                 pair, (G, S, F, T, C) in f32; with the flow output
//                 (transform_warp_pairs, the training forward) it also
//                 writes the flow (G, S, F, T, 2) and each row's softmax
//                 log-sum-exp (G, S, F, T), which the flash backward
//                 (transform_warp_bwd.cu) reads instead of recomputing the
//                 row statistics; without it (transform_warp_pairs_nf) only
//                 the warped features.
//
// For each target pixel t of frame f and each source s of group g:
//   z[t, u]  = temp * <tar_n[g, f, t], src_n[g, s, u]> * (mt*ms + (1-mt)(1-ms))
//   flow[t]  = sum_u softmax_u(z[t, :]) * grid[u]
//   warp[t]  = zeros-padded bilinear sample of src[g, s] at flow[t]
// The mask enters as a multiplicative coefficient on the logit: a
// cross-region pair gets logit 0, not -inf.
//
// What bounds it: fp32 arithmetic. The logits are 2*S*T*T*C flops per
// frame (3.2 GFLOP at S=3, T=1024, C=512) and must keep fp32 accuracy
// (temp 100 multiplies any logit error by 100 inside exp), so they run as
// fp32 FMAs on the CUDA cores, never TF32 or bf16 tensor-core products.
// Memory traffic is small beside that (~3 MB a frame for the mean form).
//
// Design: one block takes one (group, frame) and a tile of TM = 64 target
// rows. Per source it streams the normalised source rows through shared
// memory in chunks of TN = 64 rows x KC = 32 channels (a whole source,
// 1024 x 512 f32 = 2 MB, does not fit), each of the 256 threads
// accumulating a 4 x 4 register tile of logits with rows and columns
// strided by 16 (so the shared-memory reads are conflict-free). Each
// thread keeps an online softmax (running max, sum and the 2-float flow
// numerator) over its own columns; after the last chunk the 16 column
// owners of a row merge theirs with warp shuffles. The flow becomes four
// corner indices and weights per (source, row), kept in shared memory. A
// second phase gathers the four neighbours of the un-normalised source
// rows (a 4-tap gather, not the TPU's dense tent-weight matmul),
// channel-contiguous across threads, and either averages over sources in
// registers (MEAN) or writes each pair. Rows and columns past T and
// channels past C are masked, so any T and C run without a fallback.
// The backward kernels recompute the logits with the same tiles and the
// same order of fused multiply-adds, so they see the same logits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;        // target rows per block
constexpr int TN = 64;        // source rows per chunk
constexpr int KC = 32;        // channels per k step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 logits each

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <bool MEAN, bool FLOW, typename OutT>
__global__ void __launch_bounds__(THREADS) transform_warp_kernel(
    const float* __restrict__ src,       // (G, S, T, C) un-normalised
    const float* __restrict__ src_n,     // (G, S, T, C) L2-normalised
    const float* __restrict__ src_mask,  // (G, S, T)
    const float* __restrict__ tar_n,     // (G, F, T, C) L2-normalised
    const float* __restrict__ tar_mask,  // (G, F, T)
    const float* __restrict__ grid,      // (T, 2) (x, y) in [-1, 1]
    OutT* __restrict__ out,    // MEAN: (G, F, T, C); else (G, S, F, T, C)
    float* __restrict__ flow_out,  // FLOW: (G, S, F, T, 2)
    float* __restrict__ lse_out,   // FLOW: (G, S, F, T)
    int S, int F, int T, int C, int H, int W, float temp) {
  __shared__ float As[KC][TM + 1];  // target tile, channel-major
  __shared__ float Bs[KC][TN + 1];  // source chunk, channel-major
  extern __shared__ unsigned char dyn[];
  int* corner_idx = reinterpret_cast<int*>(dyn);                 // S*TM*4
  float* corner_w = reinterpret_cast<float*>(corner_idx + S * TM * 4);

  const int f = blockIdx.y;
  const int g = blockIdx.z;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int gf = g * F + f;  // (group, frame) plane
  const float* tar_f = tar_n + (size_t)gf * T * C;
  src += (size_t)g * S * T * C;
  src_n += (size_t)g * S * T * C;
  src_mask += (size_t)g * S * T;

  float mt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    mt[i] = r < T ? tar_mask[(size_t)gf * T + r] : 0.f;
  }

  for (int s = 0; s < S; ++s) {
    const float* sn = src_n + (size_t)s * T * C;
    const float* ms = src_mask + (size_t)s * T;
    float m[4], l[4], fx[4], fy[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
      fx[i] = 0.f;
      fy[i] = 0.f;
    }

    for (int col0 = 0; col0 < T; col0 += TN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      for (int k0 = 0; k0 < C; k0 += KC) {
        // lane <-> channel: each warp reads 32 consecutive floats of a row
        for (int e = tid; e < TM * KC; e += THREADS) {
          const int k = e % KC, r = e / KC;
          const int gr = row0 + r, gk = k0 + k;
          As[k][r] = (gr < T && gk < C) ? tar_f[(size_t)gr * C + gk] : 0.f;
        }
        for (int e = tid; e < TN * KC; e += THREADS) {
          const int k = e % KC, u = e / KC;
          const int gu = col0 + u, gk = k0 + k;
          Bs[k][u] = (gu < T && gk < C) ? sn[(size_t)gu * C + gk] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < KC; ++k) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
      }

      // online softmax over this thread's columns of the chunk
      float msk[4], gx[4], gy[4];
      bool ok[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = col0 + tx + 16 * j;
        ok[j] = u < T;
        msk[j] = ok[j] ? ms[u] : 0.f;
        gx[j] = ok[j] ? grid[2 * u] : 0.f;
        gy[j] = ok[j] ? grid[2 * u + 1] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float z[4];
        float zmax = m[i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float coeff =
              mt[i] * msk[j] + (1.f - mt[i]) * (1.f - msk[j]);
          z[j] = temp * (acc[i][j] * coeff);
          if (ok[j]) zmax = fmaxf(zmax, z[j]);
        }
        if (zmax == -INFINITY) continue;  // no valid column yet
        const float scale = expf(m[i] - zmax);
        l[i] *= scale;
        fx[i] *= scale;
        fy[i] *= scale;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!ok[j]) continue;
          const float p = expf(z[j] - zmax);
          l[i] += p;
          fx[i] = fmaf(p, gx[j], fx[i]);
          fy[i] = fmaf(p, gy[j], fy[i]);
        }
        m[i] = zmax;
      }
    }

    // merge the 16 column owners of each row: lanes that differ in tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
        const float xo = __shfl_xor_sync(0xffffffffu, fx[i], off);
        const float yo = __shfl_xor_sync(0xffffffffu, fy[i], off);
        const float mn = fmaxf(m[i], mo);
        if (mn == -INFINITY) continue;
        const float a = expf(m[i] - mn), b = expf(mo - mn);
        l[i] = l[i] * a + lo * b;
        fx[i] = fx[i] * a + xo * b;
        fy[i] = fy[i] * a + yo * b;
        m[i] = mn;
      }
      if (tx == 0) {
        const int r = ty + 16 * i;
        const float flx = fx[i] / l[i], fly = fy[i] / l[i];
        if (FLOW && row0 + r < T) {
          const size_t row = ((size_t)(g * S + s) * F + f) * T + row0 + r;
          flow_out[2 * row] = flx;
          flow_out[2 * row + 1] = fly;
          lse_out[row] = m[i] + logf(l[i]);
        }
        // grid_sample(align_corners=False) unnormalisation
        const float ix = ((flx + 1.f) * W - 1.f) * 0.5f;
        const float iy = ((fly + 1.f) * H - 1.f) * 0.5f;
        const float x0 = floorf(ix), y0 = floorf(iy);
        const float wx = ix - x0, wy = iy - y0;
        const int xi = (int)x0, yi = (int)y0;
        const int cy[4] = {yi, yi, yi + 1, yi + 1};
        const int cx[4] = {xi, xi + 1, xi, xi + 1};
        const float cw[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx,
                             wy * (1.f - wx), wy * wx};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool in = cx[q] >= 0 && cx[q] <= W - 1 && cy[q] >= 0 &&
                          cy[q] <= H - 1;
          const int slot = (s * TM + r) * 4 + q;
          corner_idx[slot] = in ? cy[q] * W + cx[q] : 0;
          corner_w[slot] = in ? cw[q] : 0.f;
        }
      }
    }
  }
  __syncthreads();

  // 4-tap gather of the un-normalised sources, channel-contiguous
  for (int r = 0; r < TM; ++r) {
    const int gr = row0 + r;
    if (gr >= T) break;
    for (int c = tid; c < C; c += THREADS) {
      float acc = 0.f;
      for (int s = 0; s < S; ++s) {
        const float* sf = src + (size_t)s * T * C + c;
        const int* ci = corner_idx + (s * TM + r) * 4;
        const float* cw = corner_w + (s * TM + r) * 4;
        float v = cw[0] * sf[(size_t)ci[0] * C];
        v += cw[1] * sf[(size_t)ci[1] * C];
        v += cw[2] * sf[(size_t)ci[2] * C];
        v += cw[3] * sf[(size_t)ci[3] * C];
        if (MEAN) {
          acc += v;
        } else {
          store(out + (((size_t)(g * S + s) * F + f) * T + gr) * C + c, v);
        }
      }
      if (MEAN) store(out + ((size_t)gf * T + gr) * C + c, acc / S);
    }
  }
}

template <bool MEAN, bool FLOW, typename OutT>
cudaError_t launch(const void* src, const void* src_n, const void* src_mask,
                   const void* tar_n, const void* tar_mask, const void* grid,
                   void* out, void* flow, void* lse, int G, int S, int F,
                   int T, int C, int H, int W, float temp,
                   cudaStream_t stream) {
  auto kernel = transform_warp_kernel<MEAN, FLOW, OutT>;
  const size_t dyn = (size_t)S * TM * 4 * (sizeof(int) + sizeof(float));
  if (dyn > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch reports its own
      return e;
    }
  }
  const dim3 blocks((T + TM - 1) / TM, F, G);
  kernel<<<blocks, THREADS, dyn, stream>>>(
      static_cast<const float*>(src), static_cast<const float*>(src_n),
      static_cast<const float*>(src_mask), static_cast<const float*>(tar_n),
      static_cast<const float*>(tar_mask), static_cast<const float*>(grid),
      static_cast<OutT*>(out), static_cast<float*>(flow),
      static_cast<float*>(lse), S, F, T, C, H, W, temp);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mean != 0: out is (G, F, T, C) in bf16 (out_bf16 != 0) or f32; flow and
// lse must be null. mean == 0: out is (G, S, F, T, C) in f32, and flow
// (G, S, F, T, 2) and lse (G, S, F, T) are written unless null.
int tsnet_transform_warp(const void* src, const void* src_n,
                         const void* src_mask, const void* tar_n,
                         const void* tar_mask, const void* grid, void* out,
                         void* flow, void* lse, int G, int S, int F, int T,
                         int C, int H, int W, float temp, int mean,
                         int out_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((flow == nullptr) != (lse == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!mean) {
    if (out_bf16) return (int)cudaErrorInvalidValue;
    if (flow != nullptr)
      return (int)launch<false, true, float>(src, src_n, src_mask, tar_n,
                                             tar_mask, grid, out, flow, lse,
                                             G, S, F, T, C, H, W, temp, st);
    return (int)launch<false, false, float>(src, src_n, src_mask, tar_n,
                                            tar_mask, grid, out, nullptr,
                                            nullptr, G, S, F, T, C, H, W,
                                            temp, st);
  }
  if (flow != nullptr) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return (int)launch<true, false, __nv_bfloat16>(
        src, src_n, src_mask, tar_n, tar_mask, grid, out, nullptr, nullptr, G,
        S, F, T, C, H, W, temp, st);
  return (int)launch<true, false, float>(src, src_n, src_mask, tar_n,
                                         tar_mask, grid, out, nullptr,
                                         nullptr, G, S, F, T, C, H, W, temp,
                                         st);
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
