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
// Design: the logits and softmax of csrc/transform_warp.cu without its
// warp. The TPU kernel keeps the whole source (S x C f32, 2 MB) resident
// and pads the 2-wide grid to 128 lanes so that P @ grid rides its matrix
// unit, writing a (B, T, 128) output; neither carries over. One block takes
// one batch element and a tile of TM = 64 target rows and streams the
// source rows through shared memory in chunks of TN = 64 rows x KC = 32
// channels, each of the 256 threads accumulating a 4 x 4 register tile of
// logits with rows and columns strided by 16 (so the shared-memory reads
// are conflict-free). Each thread keeps an online softmax (running max,
// sum and the 2-float flow numerator) over its own columns; after the last
// chunk the 16 column owners of a row merge theirs with warp shuffles and
// one of them writes the row's (x, y). Rows past T, columns past S and
// channels past C are masked, so any T, S and C run without a fallback.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;        // target rows per block
constexpr int TN = 64;        // source rows per chunk
constexpr int KC = 32;        // channels per k step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 logits each

__global__ void __launch_bounds__(THREADS) attention_flow_kernel(
    const float* __restrict__ tar,       // (B, T, C)
    const float* __restrict__ src,       // (B, S, C)
    const float* __restrict__ tar_mask,  // (B, T)
    const float* __restrict__ src_mask,  // (B, S)
    const float* __restrict__ grid,      // (S, 2)
    float* __restrict__ flow,            // (B, T, 2)
    int T, int S, int C, float temp) {
  __shared__ float As[KC][TM + 1];  // target tile, channel-major
  __shared__ float Bs[KC][TN + 1];  // source chunk, channel-major

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float* tar_b = tar + (size_t)b * T * C;
  const float* src_b = src + (size_t)b * S * C;
  const float* ms = src_mask + (size_t)b * S;

  float mt[4], m[4], l[4], fx[4], fy[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    mt[i] = r < T ? tar_mask[(size_t)b * T + r] : 0.f;
    m[i] = -INFINITY;
    l[i] = 0.f;
    fx[i] = 0.f;
    fy[i] = 0.f;
  }

  for (int col0 = 0; col0 < S; col0 += TN) {
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
        As[k][r] = (gr < T && gk < C) ? tar_b[(size_t)gr * C + gk] : 0.f;
      }
      for (int e = tid; e < TN * KC; e += THREADS) {
        const int k = e % KC, u = e / KC;
        const int gu = col0 + u, gk = k0 + k;
        Bs[k][u] = (gu < S && gk < C) ? src_b[(size_t)gu * C + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // online softmax over this thread's columns of the chunk
    float msk[4], gx[4], gy[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = col0 + tx + 16 * j;
      ok[j] = u < S;
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
        const float coeff = mt[i] * msk[j] + (1.f - mt[i]) * (1.f - msk[j]);
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
      const float a = expf(m[i] - mn), bw = expf(mo - mn);
      l[i] = l[i] * a + lo * bw;
      fx[i] = fx[i] * a + xo * bw;
      fy[i] = fy[i] * a + yo * bw;
      m[i] = mn;
    }
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < T) {
      const size_t row = (size_t)b * T + r;
      flow[2 * row] = fx[i] / l[i];
      flow[2 * row + 1] = fy[i] / l[i];
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
  attention_flow_kernel<<<blocks, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
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
