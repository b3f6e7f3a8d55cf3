// Flash backward of the transformation branch for Hopper (sm_90a): the six
// input cotangents of transform_warp_pairs (transform_warp.cu, pairs form
// with the flow output), without the (T, T) attention ever reaching
// device memory.
//
// Replaces the TPU kernel wacv23_tsnet_tpu/ops/pallas_similarity.py
// _pairs_bwd_pallas/_pairs_bwd_kernel (called from _pairs_bwd). Per pair
// (group g, source s, frame f), with L = tn sn^T the logits, K the mask
// coefficient, z = temp L K, P = softmax(z), flow = P grid and the warp a
// bilinear 4-tap gather of the un-normalised source a at the flow:
//
//   gflow[t] = gf[t] + (W/2, H/2) * sum_q <gw[t], a[corner_q]> dweight_q
//   da[u]   += sum over the rows t whose corners hit u of weight * gw[t]
//   gP       = gflow_x gx^T + gflow_y gy^T (rank 2), and since flow = P grid,
//              rowsum(gP o P) = gflow . flow, so
//   gz[t, u] = P[t, u] (gflow_x[t] (gx[u] - flow_x[t])
//                       + gflow_y[t] (gy[u] - flow_y[t]))
//   gL = temp K gz ; gK = temp L gz
//   gtn[t] = sum_s sum_u gL[t, u] sn[u]    gmt[t] = sum_s sum_u gK (2 ms - 1)
//   gsn[u] = sum_f sum_t gL[t, u] tn[t]    gms[u] = sum_f sum_t gK (2 mt - 1)
//   ggrid[u] = sum_{g,s,f} sum_t P[t, u] gflow[t]
//
// P is exp(z - lse[t]) with the row log-sum-exp the forward saved, so no
// pass recomputes a row's max and sum.
//
// What bounds it: fp32 arithmetic. Three T x T x C products per pair (the
// logits, gtn and gsn; 3.2 GFLOP a pair at T = 1024, C = 512) must stay
// fp32 (temp 100 multiplies any logit error by 100), so they are FMAs on
// the CUDA cores, as in the forward. Bytes are a few MB a pair.
//
// Design (three kernels, no atomics on the big sums):
//   warp_bwd  one warp per (pair, target row): the 4-tap dot products
//             give gflow (written for the other two kernels), and da is a
//             4-tap scatter-add (fp32 atomics into a zeroed da; a source
//             pixel is hit by a handful of rows, so contention is low).
//   rows_bwd  one block per (group, frame, 64-row target tile), looping
//             over sources and 64-column source chunks: recompute the
//             logit tile, form gL and gK, and accumulate gtn for the tile
//             in shared memory (64 rows x 512 channels) and gmt in
//             registers. The sum over sources happens inside the block.
//   cols_bwd  one block per (group, source, 64-column source chunk),
//             looping over frames and target tiles: the same recompute,
//             accumulating gsn, gms and a per-(group, source) partial of
//             ggrid. The sum over frames and rows happens inside the block.
// This is the flash-attention-2 split: each big sum is owned by one block,
// at the price of computing the logits twice (4 T x T x C products
// instead of 3). One kernel with atomics for gtn would have needed some
// 8 M atomic adds a pair. The sums are in a fixed order except da's, so
// the kernel is held against its plain version at a tolerance.
//
// Any T and C: rows, columns and channels past the edge are masked; the
// shared-memory accumulators cover CSLAB channels at a time, and a larger
// C loops over slabs (recomputing the logits for each).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TM = 64;        // target rows per tile
constexpr int TN = 64;        // source rows per chunk
constexpr int KC = 32;        // channels per logit k step
constexpr int CC = 64;        // channels per product step
constexpr int CSLAB = 512;    // channels of the shared accumulator
constexpr int ACC_LD = CSLAB + 16;  // row stride: rows ty, ty+1 on other banks
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 elements each

// Logits of one (TM target rows) x (TN source rows) tile into acc: each
// logit one in-order chain of FMAs over the channels from 0, as the
// forward's tile (attention_tile_sm90.cuh) computes it, so both see the
// same logits bit for bit. tar/src point at row 0 of their (T, C) planes.
__device__ __forceinline__ void logit_tile(
    const float* __restrict__ tar, const float* __restrict__ src, int row0,
    int col0, int T, int C, float (*As)[TM + 1], float (*Bs)[TN + 1],
    float acc[4][4]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < C; k0 += KC) {
    for (int e = tid; e < TM * KC; e += THREADS) {
      const int k = e % KC, r = e / KC;
      const int gr = row0 + r, gk = k0 + k;
      As[k][r] = (gr < T && gk < C) ? tar[(size_t)gr * C + gk] : 0.f;
    }
    for (int e = tid; e < TN * KC; e += THREADS) {
      const int k = e % KC, u = e / KC;
      const int gu = col0 + u, gk = k0 + k;
      Bs[k][u] = (gu < T && gk < C) ? src[(size_t)gu * C + gk] : 0.f;
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
}

// Per target row of a tile: what the softmax backward needs.
struct RowData {
  float mt, lse, flx, fly, gfx, gfy;
};

__device__ __forceinline__ RowData load_row(
    int r, int T, const float* mt, const float* lse, const float* flow,
    const float* gflow) {
  RowData d = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (r < T) {
    d.mt = mt[r];
    d.lse = lse[r];
    d.flx = flow[2 * r];
    d.fly = flow[2 * r + 1];
    d.gfx = gflow[2 * r];
    d.gfy = gflow[2 * r + 1];
  }
  return d;
}

// gz = P (gflow . (grid[u] - flow[t])); returns gL, sets gK and P.
__device__ __forceinline__ float softmax_bwd(float logit, const RowData& rd,
                                             float ms, float gx, float gy,
                                             bool ok, float temp, float* gk,
                                             float* p_out) {
  const float coeff = rd.mt * ms + (1.f - rd.mt) * (1.f - ms);
  const float z = temp * (logit * coeff);
  const float p = ok ? expf(z - rd.lse) : 0.f;
  const float gz = p * (rd.gfx * (gx - rd.flx) + rd.gfy * (gy - rd.fly));
  *gk = temp * logit * gz;
  *p_out = p;
  return temp * coeff * gz;
}

// ---- warp backward: gflow and the da scatter, one warp per row ----------
__global__ void __launch_bounds__(THREADS) warp_bwd_kernel(
    const float* __restrict__ src,    // (G, S, T, C) un-normalised
    const float* __restrict__ flow,   // (G, S, F, T, 2)
    const float* __restrict__ gw,     // (G, S, F, T, C)
    const float* __restrict__ gf,     // (G, S, F, T, 2)
    float* __restrict__ gflow,        // (G, S, F, T, 2) out
    float* __restrict__ da,           // (G, S, T, C) out, zeroed
    int S, int F, int T, int C, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int pair = blockIdx.y;               // (g * S + s) * F + f
  if (t >= T) return;
  const int gs = pair / F;                   // g * S + s
  const size_t row = (size_t)pair * T + t;
  const float* a = src + (size_t)gs * T * C;
  const float* gwr = gw + row * C;
  float* dag = da + (size_t)gs * T * C;

  const float ix = ((flow[2 * row] + 1.f) * W - 1.f) * 0.5f;
  const float iy = ((flow[2 * row + 1] + 1.f) * H - 1.f) * 0.5f;
  const float x0 = floorf(ix), y0 = floorf(iy);
  const float wx = ix - x0, wy = iy - y0;
  const int xi = (int)x0, yi = (int)y0;
  const int cy[4] = {yi, yi, yi + 1, yi + 1};
  const int cx[4] = {xi, xi + 1, xi, xi + 1};
  const float cw[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx,
                       wy * (1.f - wx), wy * wx};
  // d weight / d ix and d weight / d iy of each corner
  const float dwx[4] = {-(1.f - wy), 1.f - wy, -wy, wy};
  const float dwy[4] = {-(1.f - wx), -wx, 1.f - wx, wx};
  int idx[4];
  bool in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    in[q] = cx[q] >= 0 && cx[q] <= W - 1 && cy[q] >= 0 && cy[q] <= H - 1;
    idx[q] = in[q] ? cy[q] * W + cx[q] : 0;
  }

  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < C; c += 32) {
    const float g = gwr[c];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!in[q]) continue;
      dot[q] = fmaf(g, a[(size_t)idx[q] * C + c], dot[q]);
      atomicAdd(dag + (size_t)idx[q] * C + c, cw[q] * g);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot[q] += __shfl_xor_sync(0xffffffffu, dot[q], off);
  if (lane == 0) {
    float gix = 0.f, giy = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!in[q]) continue;
      gix = fmaf(dot[q], dwx[q], gix);
      giy = fmaf(dot[q], dwy[q], giy);
    }
    gflow[2 * row] = gf[2 * row] + gix * (W * 0.5f);
    gflow[2 * row + 1] = gf[2 * row + 1] + giy * (H * 0.5f);
  }
}

// ---- rows: gtn and gmt, one block per (group, frame, target tile) -------
__global__ void __launch_bounds__(THREADS) rows_bwd_kernel(
    const float* __restrict__ src_n,     // (G, S, T, C)
    const float* __restrict__ src_mask,  // (G, S, T)
    const float* __restrict__ tar_n,     // (G, F, T, C)
    const float* __restrict__ tar_mask,  // (G, F, T)
    const float* __restrict__ grid,      // (T, 2)
    const float* __restrict__ flow,      // (G, S, F, T, 2)
    const float* __restrict__ lse,       // (G, S, F, T)
    const float* __restrict__ gflow,     // (G, S, F, T, 2)
    float* __restrict__ gtn,             // (G, F, T, C) out
    float* __restrict__ gmt,             // (G, F, T) out
    int S, int F, int T, int C, float temp) {
  __shared__ float As[KC][TM + 1];
  __shared__ float Bs[KC][TN + 1];
  __shared__ float gLs[TN][TM + 1];     // gL tile, source-major
  extern __shared__ float dyn[];
  float* acc_s = dyn;                   // [TM][ACC_LD] gtn accumulator
  float* Ss = dyn + TM * ACC_LD;        // [TN][CC] source channel slice

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * TM;
  const int f = blockIdx.y, g = blockIdx.z;
  const int gf = g * F + f;
  const float* tn = tar_n + (size_t)gf * T * C;
  const float* mtp = tar_mask + (size_t)gf * T;

  float gmt_part[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c_lo = 0; c_lo < C; c_lo += CSLAB) {
    const int cw = min(CSLAB, C - c_lo);
    for (int e = tid; e < TM * ACC_LD; e += THREADS) acc_s[e] = 0.f;
    __syncthreads();
    for (int s = 0; s < S; ++s) {
      const int gs = g * S + s;
      const float* sn = src_n + (size_t)gs * T * C;
      const float* msp = src_mask + (size_t)gs * T;
      const size_t prow = (size_t)(gs * F + f) * T;   // pair row 0
      RowData rd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        rd[i] = load_row(row0 + ty + 16 * i, T, mtp, lse + prow,
                         flow + 2 * prow, gflow + 2 * prow);
      for (int col0 = 0; col0 < T; col0 += TN) {
        float logit[4][4];
        logit_tile(tn, sn, row0, col0, T, C, As, Bs, logit);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = col0 + tx + 16 * j;
          const bool ok = u < T;
          const float ms = ok ? msp[u] : 0.f;
          const float gx = ok ? grid[2 * u] : 0.f;
          const float gy = ok ? grid[2 * u + 1] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float gk, p;
            const float gl = softmax_bwd(logit[i][j], rd[i], ms, gx, gy, ok,
                                         temp, &gk, &p);
            if (c_lo == 0) gmt_part[i] = fmaf(gk, 2.f * ms - 1.f, gmt_part[i]);
            gLs[tx + 16 * j][ty + 16 * i] = gl;
          }
        }
        __syncthreads();
        // acc[t][c] += sum_u gL[t][u] sn[u][c], CC channels at a time
        for (int cc0 = 0; cc0 < cw; cc0 += CC) {
          for (int e = tid; e < TN * CC; e += THREADS) {
            const int c = e % CC, u = e / CC;
            const int gu = col0 + u, gc = c_lo + cc0 + c;
            Ss[u * CC + c] =
                (gu < T && cc0 + c < cw) ? sn[(size_t)gu * C + gc] : 0.f;
          }
          __syncthreads();
          float o[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              o[i][j] = acc_s[(ty + 16 * i) * ACC_LD + cc0 + tx + 16 * j];
#pragma unroll 8
          for (int u = 0; u < TN; ++u) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = gLs[u][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Ss[u * CC + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc_s[(ty + 16 * i) * ACC_LD + cc0 + tx + 16 * j] = o[i][j];
          __syncthreads();
        }
      }
    }
    // write the slab of gtn, channel-contiguous
    for (int e = tid; e < TM * cw; e += THREADS) {
      const int c = e % cw, r = e / cw;
      if (row0 + r < T)
        gtn[((size_t)gf * T + row0 + r) * C + c_lo + c] = acc_s[r * ACC_LD + c];
    }
    __syncthreads();
  }
  // gmt: merge the 16 column owners of each row (lanes that differ in tx)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      gmt_part[i] += __shfl_xor_sync(0xffffffffu, gmt_part[i], off);
    const int r = row0 + ty + 16 * i;
    if (tx == 0 && r < T) gmt[(size_t)gf * T + r] = gmt_part[i];
  }
}

// ---- cols: gsn, gms, ggrid, one block per (group, source, source chunk) --
__global__ void __launch_bounds__(THREADS) cols_bwd_kernel(
    const float* __restrict__ src_n,     // (G, S, T, C)
    const float* __restrict__ src_mask,  // (G, S, T)
    const float* __restrict__ tar_n,     // (G, F, T, C)
    const float* __restrict__ tar_mask,  // (G, F, T)
    const float* __restrict__ grid,      // (T, 2)
    const float* __restrict__ flow,      // (G, S, F, T, 2)
    const float* __restrict__ lse,       // (G, S, F, T)
    const float* __restrict__ gflow,     // (G, S, F, T, 2)
    float* __restrict__ gsn,             // (G, S, T, C) out
    float* __restrict__ gms,             // (G, S, T) out
    float* __restrict__ gg_part,         // (G, S, T, 2) out
    int S, int F, int T, int C, float temp) {
  __shared__ float As[KC][TM + 1];
  __shared__ float Bs[KC][TN + 1];
  __shared__ float gLs[TM][TN + 1];     // gL tile, target-major
  __shared__ float red[16][TN][3];      // column partials across ty
  extern __shared__ float dyn[];
  float* acc_s = dyn;                   // [TN][ACC_LD] gsn accumulator
  float* Ts = dyn + TN * ACC_LD;        // [TM][CC] target channel slice

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int col0 = blockIdx.x * TN;
  const int s = blockIdx.y, g = blockIdx.z;
  const int gs = g * S + s;
  const float* sn = src_n + (size_t)gs * T * C;
  const float* msp = src_mask + (size_t)gs * T;

  float ms[4], gx[4], gy[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = col0 + tx + 16 * j;
    ok[j] = u < T;
    ms[j] = ok[j] ? msp[u] : 0.f;
    gx[j] = ok[j] ? grid[2 * u] : 0.f;
    gy[j] = ok[j] ? grid[2 * u + 1] : 0.f;
  }
  float gms_part[4] = {0.f, 0.f, 0.f, 0.f};
  float ggx_part[4] = {0.f, 0.f, 0.f, 0.f};
  float ggy_part[4] = {0.f, 0.f, 0.f, 0.f};

  for (int c_lo = 0; c_lo < C; c_lo += CSLAB) {
    const int cw = min(CSLAB, C - c_lo);
    for (int e = tid; e < TN * ACC_LD; e += THREADS) acc_s[e] = 0.f;
    __syncthreads();
    for (int f = 0; f < F; ++f) {
      const int gf = g * F + f;
      const float* tn = tar_n + (size_t)gf * T * C;
      const float* mtp = tar_mask + (size_t)gf * T;
      const size_t prow = (size_t)(gs * F + f) * T;
      for (int row0 = 0; row0 < T; row0 += TM) {
        RowData rd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rd[i] = load_row(row0 + ty + 16 * i, T, mtp, lse + prow,
                           flow + 2 * prow, gflow + 2 * prow);
        float logit[4][4];
        logit_tile(tn, sn, row0, col0, T, C, As, Bs, logit);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float sm = 2.f * rd[i].mt - 1.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float gk, p;
            const float gl = softmax_bwd(logit[i][j], rd[i], ms[j], gx[j],
                                         gy[j], ok[j], temp, &gk, &p);
            if (c_lo == 0) {
              gms_part[j] = fmaf(gk, sm, gms_part[j]);
              ggx_part[j] = fmaf(p, rd[i].gfx, ggx_part[j]);
              ggy_part[j] = fmaf(p, rd[i].gfy, ggy_part[j]);
            }
            gLs[ty + 16 * i][tx + 16 * j] = gl;
          }
        }
        __syncthreads();
        // acc[u][c] += sum_t gL[t][u] tn[t][c], CC channels at a time
        for (int cc0 = 0; cc0 < cw; cc0 += CC) {
          for (int e = tid; e < TM * CC; e += THREADS) {
            const int c = e % CC, r = e / CC;
            const int gr = row0 + r, gc = c_lo + cc0 + c;
            Ts[r * CC + c] =
                (gr < T && cc0 + c < cw) ? tn[(size_t)gr * C + gc] : 0.f;
          }
          __syncthreads();
          float o[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              o[i][j] = acc_s[(ty + 16 * i) * ACC_LD + cc0 + tx + 16 * j];
#pragma unroll 8
          for (int r = 0; r < TM; ++r) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = gLs[r][ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = Ts[r * CC + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) o[i][j] = fmaf(a[i], b[j], o[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc_s[(ty + 16 * i) * ACC_LD + cc0 + tx + 16 * j] = o[i][j];
          __syncthreads();
        }
      }
    }
    for (int e = tid; e < TN * cw; e += THREADS) {
      const int c = e % cw, u = e / cw;
      if (col0 + u < T)
        gsn[((size_t)gs * T + col0 + u) * C + c_lo + c] = acc_s[u * ACC_LD + c];
    }
    __syncthreads();
  }
  // gms and ggrid: sum the 16 row owners (ty) of each column
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    red[ty][tx + 16 * j][0] = gms_part[j];
    red[ty][tx + 16 * j][1] = ggx_part[j];
    red[ty][tx + 16 * j][2] = ggy_part[j];
  }
  __syncthreads();
  if (tid < TN && col0 + tid < T) {
    float sums[3] = {0.f, 0.f, 0.f};
    for (int y = 0; y < 16; ++y)
#pragma unroll
      for (int k = 0; k < 3; ++k) sums[k] += red[y][tid][k];
    const size_t u = (size_t)gs * T + col0 + tid;
    gms[u] = sums[0];
    gg_part[2 * u] = sums[1];
    gg_part[2 * u + 1] = sums[2];
  }
}

cudaError_t set_smem(const void* kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return e;
}

}  // namespace

extern "C" {

// Every pointer is a contiguous f32 tensor on the device; da must be
// zeroed by the caller (the scatter adds into it). gflow is scratch of
// the shape of flow. Shapes as in the kernels' signatures above.
int tsnet_transform_warp_bwd(
    const void* src, const void* src_n, const void* src_mask,
    const void* tar_n, const void* tar_mask, const void* grid,
    const void* flow, const void* lse, const void* gw, const void* gf,
    void* gflow, void* da, void* gtn, void* gsn, void* gmt, void* gms,
    void* gg_part, int G, int S, int F, int T, int C, int H, int W,
    float temp, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fsrc = static_cast<const float*>(src);
  const float* fsrc_n = static_cast<const float*>(src_n);
  const float* fsm = static_cast<const float*>(src_mask);
  const float* ftar_n = static_cast<const float*>(tar_n);
  const float* ftm = static_cast<const float*>(tar_mask);
  const float* fgrid = static_cast<const float*>(grid);
  const float* fflow = static_cast<const float*>(flow);
  const float* flse = static_cast<const float*>(lse);
  float* fgflow = static_cast<float*>(gflow);

  const dim3 wblocks((T + THREADS / 32 - 1) / (THREADS / 32), G * S * F);
  warp_bwd_kernel<<<wblocks, THREADS, 0, st>>>(
      fsrc, fflow, static_cast<const float*>(gw),
      static_cast<const float*>(gf), fgflow, static_cast<float*>(da), S, F,
      T, C, H, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t rows_dyn = (size_t)(TM * ACC_LD + TN * CC) * sizeof(float);
  e = set_smem((const void*)rows_bwd_kernel, rows_dyn);
  if (e != cudaSuccess) return (int)e;
  rows_bwd_kernel<<<dim3((T + TM - 1) / TM, F, G), THREADS, rows_dyn, st>>>(
      fsrc_n, fsm, ftar_n, ftm, fgrid, fflow, flse, fgflow,
      static_cast<float*>(gtn), static_cast<float*>(gmt), S, F, T, C, temp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t cols_dyn = (size_t)(TN * ACC_LD + TM * CC) * sizeof(float);
  e = set_smem((const void*)cols_bwd_kernel, cols_dyn);
  if (e != cudaSuccess) return (int)e;
  cols_bwd_kernel<<<dim3((T + TN - 1) / TN, S, G), THREADS, cols_dyn, st>>>(
      fsrc_n, fsm, ftar_n, ftm, fgrid, fflow, flse, fgflow,
      static_cast<float*>(gsn), static_cast<float*>(gms),
      static_cast<float*>(gg_part), S, F, T, C, temp);
  return (int)cudaGetLastError();
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
