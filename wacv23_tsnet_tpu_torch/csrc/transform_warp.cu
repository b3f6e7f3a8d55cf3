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
// Design: one block of 128 threads takes one (group, frame) and a tile of
// 64 target rows; grid (T/64, F, G). At two blocks an SM (264 at once on
// 132 SMs) that is 512 blocks at F = 32 (two rounds, 97% of the slots),
// 1024 for the 64-frame clip (four rounds) and 240 for the train step's
// G = 15, F = 1 (one round, 108 SMs with two blocks and 24 with one).
// Per source, the shared logit tile of csrc/attention_tile_sm90.cuh
// streams the normalised source rows past the target tile (8 x 8 fp32
// register blocks fed by 16-byte shared loads, chunks double-buffered by
// cp.async; the header says what bounds it and what the tile does about
// it) and leaves each row's online softmax merged across its column
// owners. Lane tx of a row group turns row tx's flow
// into four corner indices and weights per (source, row), kept in shared
// memory. A second phase gathers the four neighbours of the un-normalised
// source rows (a 4-tap gather, not the TPU's dense tent-weight matmul),
// channel-contiguous across threads, and either averages over sources in
// registers (MEAN) or writes each pair. Rows and columns past T and
// channels past C are masked, so any T and C run without a fallback.
// The backward (transform_warp_bwd.cu) recomputes the logits on the same
// tile, each the same in-order chain of fp32 FMAs over the channels, so
// it sees bitwise the same logits, and forms P = exp(z - lse) with the
// log-sum-exp written here. That log-sum-exp comes from sums taken in
// the tile's order (see the header), so it may differ from another
// order's in the last bits: a change in P of order temp * 1e-7, within
// K4's tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile_sm90.cuh"

namespace {

using namespace tsnet_attn;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <bool MEAN, bool FLOW, typename OutT, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) transform_warp_kernel(
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
  __shared__ __align__(16) Smem sm;
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

  float mt[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + tile_row(ty, i);
    mt[i] = r < T ? tar_mask[(size_t)gf * T + r] : 0.f;
  }

  for (int s = 0; s < S; ++s) {
    RowStats st;
    attend<VEC>(tar_f, src_n + (size_t)s * T * C, src_mask + (size_t)s * T,
                grid, mt, row0, T, T, C, temp, sm, st);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      if (tx != i) continue;
      const int r = tile_row(ty, i);
      const float flx = st.fx[i] / st.l[i], fly = st.fy[i] / st.l[i];
      if (FLOW && row0 + r < T) {
        const size_t row = ((size_t)(g * S + s) * F + f) * T + row0 + r;
        flow_out[2 * row] = flx;
        flow_out[2 * row + 1] = fly;
        lse_out[row] = st.m[i] + logf(st.l[i]);
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
  auto kernel = vector_loads(C, src_n, tar_n)
                    ? transform_warp_kernel<MEAN, FLOW, OutT, true>
                    : transform_warp_kernel<MEAN, FLOW, OutT, false>;
  const size_t dyn = (size_t)S * TM * 4 * (sizeof(int) + sizeof(float));
  if (dyn + sizeof(Smem) > 48 * 1024) {  // past the default 48 KB a block
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
