// Masked attention flow of TS-Net for Hopper (sm_90a): masked temp-100
// similarity -> softmax -> coordinate flow, one kernel.
//
// Replaces the TPU kernel wacv23_tsnet_tpu/ops/pallas_similarity.py:
// masked_attention_flow_fused (_flow_pallas/_flow_kernel). For each batch
// element b and target row t:
//   z[t, s]  = temp * <tar[b, t], src[b, s]> * (mt*ms + (1-mt)(1-ms))
//   flow[t]  = sum_s softmax_s(z[t, :]) * grid[s]
// with tar (B, T, C), src (B, S, C), masks (B, T) and (B, S), grid (S, 2),
// all f32, and flow (B, T, 2) f32. The mask is a real-valued coefficient on
// the logit: a cross-region pair gets logit 0, not -inf. The (B, T, S)
// attention is never written.
//
// What bounds it: fp32 arithmetic. The logits are 2*T*S*C flops per batch
// element (1.07 GFLOP at T=S=1024, C=512) and must keep fp32 accuracy
// (temp 100 multiplies any logit error by 100 inside exp), so they run as
// fp32 FMAs on the CUDA cores, never TF32 or bf16 tensor-core products.
// Memory traffic is small beside that (~4 MB a batch element).
//
// Design: the TPU kernel keeps the whole source (S x C f32, 2 MB) resident
// and pads the 2-wide grid to 128 lanes so that P @ grid rides its matrix
// unit, writing a (B, T, 128) output; neither carries over. One block of
// 128 threads takes one batch element and a tile of 64 target rows, and
// the shared logit tile of csrc/attention_tile_sm90.cuh streams the source
// past it (8 x 8 fp32 register blocks fed by 16-byte shared loads, chunks
// double-buffered by cp.async; see the header for what bounds it and what
// the tile does about it). The tile leaves each row's online
// softmax merged across its column owners; lane tx of a row group writes
// the (x, y) of its row tx. Rows past T, columns past S and channels past
// C are masked, so any T, S and C run without a fallback. Grid: (T/64, B),
// 240 blocks at B = 15, T = 1024: at two blocks an SM, one wave on 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile_sm90.cuh"

namespace {

using namespace tsnet_attn;

template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) attention_flow_kernel(
    const float* __restrict__ tar,       // (B, T, C)
    const float* __restrict__ src,       // (B, S, C)
    const float* __restrict__ tar_mask,  // (B, T)
    const float* __restrict__ src_mask,  // (B, S)
    const float* __restrict__ grid,      // (S, 2)
    float* __restrict__ flow,            // (B, T, 2)
    int T, int S, int C, float temp) {
  __shared__ __align__(16) Smem sm;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float mt[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + tile_row(ty, i);
    mt[i] = r < T ? tar_mask[(size_t)b * T + r] : 0.f;
  }
  RowStats st;
  attend<VEC>(tar + (size_t)b * T * C, src + (size_t)b * S * C,
              src_mask + (size_t)b * S, grid, mt, row0, T, S, C, temp, sm, st);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = row0 + tile_row(ty, i);
    if (tx == i && r < T) {
      const size_t row = (size_t)b * T + r;
      flow[2 * row] = st.fx[i] / st.l[i];
      flow[2 * row + 1] = st.fy[i] / st.l[i];
    }
  }
}

}  // namespace

extern "C" {

// tar (B, T, C), src (B, S, C), tar_mask (B, T), src_mask (B, S), grid
// (S, 2) and flow (B, T, 2), all f32 and contiguous; B, T, S, C >= 1.
int tsnet_attention_flow(const void* tar, const void* src,
                         const void* tar_mask, const void* src_mask,
                         const void* grid, void* flow, int B, int T, int S,
                         int C, float temp, void* stream) {
  if (B < 1 || T < 1 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const dim3 blocks((T + TM - 1) / TM, B);
  auto kernel = vector_loads(C, tar, src) ? attention_flow_kernel<true>
                                          : attention_flow_kernel<false>;
  kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tar), static_cast<const float*>(src),
      static_cast<const float*>(tar_mask), static_cast<const float*>(src_mask),
      static_cast<const float*>(grid), static_cast<float*>(flow), T, S, C,
      temp);
  return (int)cudaGetLastError();
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
