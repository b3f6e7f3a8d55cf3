// Flash backward of the transformation branch for Hopper (sm_90a): the six
// input cotangents of transform_warp_pairs (transform_warp.cu, pairs form
// with the flow output).
//
// Replaces the TPU kernel wacv23_tsnet_tpu/ops/pallas_similarity.py
// _pairs_bwd_pallas/_pairs_bwd_kernel (called from _pairs_bwd). Per pair
// (group g, source s, frame f), with L = tn sn^T the logits, K the mask
// coefficient, z = temp L K, P = softmax(z), flow = P grid and the warp a
// bilinear 4-tap gather of the un-normalised source a at the flow:
//
//   gflow[t] = gf[t] + (W/2, H/2) * sum_q <gw[t], a[corner_q]> dweight_q
//   da[u]    = sum over the rows t whose corners hit u of weight * gw[t]
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
// What bounds it: arithmetic. Three T x T x C products per pair (the
// logits, gtn and gsn; 3.2 GFLOP a pair at T = 1024, C = 512). The logits
// must stay fp32 (temp 100 multiplies any logit error by 100), so they are
// FMAs on the CUDA cores, as in the forward; gtn and gsn take 3xTF32
// tensor-core products, about fp32 accuracy (sgemm_tile_sm90.cuh). Bytes
// are small beside that.
//
// Design: seven launches, exactly three products, no atomics.
//   warp_bwd   one warp per (pair, target row): the 4-tap dot products
//              give gflow (written for the logits launch).
//   da_sort    one block per (g, s): its 4 F T corner contributions (item
//              k = 4 (f T + t) + q) keyed by the source pixel they hit,
//              corners off the canvas dropped, and placed by a stable
//              counting sort: counts, an exclusive scan, and each item's
//              rank among the earlier items of its pixel, taken by one
//              warp that walks the items in k order 32 at a time
//              (__match_any_sync groups a step's equal keys).
//   da_sum     one warp per (g, s, source pixel u): the sum of weight *
//              gw row over u's bucket, in k order, written whole (a lane
//              owns 4 channels where C % 4 == 0). So da is summed in a
//              fixed order, as the JAX kernel sums it in its fixed grid
//              order, and needs no zeroed buffer.
//   logits     one block per (pair, 64-row target tile), on the logit tile
//              of attention_tile_sm90.cuh (the forward's: 8 x 8 register
//              blocks, cp.async double buffer; each logit the same in-order
//              FMA chain as K3-flow's, bit for bit), streaming 128-column
//              source chunks. Each finished chunk goes to an epilogue that
//              forms P, gL and gK and writes gL to device memory twice,
//              as (pair, T, TP) rows of u and, through a transposing
//              shared-memory stage, as (g, f, s, T, TP) rows of t (TP = T
//              rounded up to 4 floats). Row sums for gmt are merged over the
//              half-warp of column owners; column sums for gms and ggrid go
//              per (pair, row tile) into a small buffer.
//   gtn, gsn   one batched GEMM each over k-major operands, 3xTF32 on
//              the tensor cores (sgemm_tile_sm90.cuh): gtn = sum_s gL_s^T
//              sn_s per (g, f), depth S * T, from the (g, f, s, T, TP)
//              copy; gsn = sum_f gL_f^T tn_f per (g, s), depth F * T, from
//              the (pair, T, TP) copy. Both read their operands as stored,
//              16 bytes a copy.
//   reduce     the per-pair partials into gmt (over s), gms and the
//              per-(g, s) ggrid partial (over f and row tiles), in a fixed
//              order.
// The gL scratch is 2 * G*S*F*T*TP floats (0.38 GB at the train shape);
// da's is 3 ints an item and T + 1 offsets a (g, s) (2.4 MB). Every sum
// runs in a fixed order, so two calls give the same bits.
//
// Any T and C: rows, columns and channels past the edge are masked; where
// C % 4 != 0 or a plane is not 16-byte aligned the same kernels copy 4
// bytes at a time.

#include <cuda_runtime.h>
#include <math.h>

#include "attention_tile_sm90.cuh"
#include "sgemm_tile_sm90.cuh"

namespace {

using tsnet_attn::RM;
using tsnet_attn::RN;
using tsnet_attn::tile_col;
using tsnet_attn::tile_row;
using tsnet_attn::TM;
using tsnet_attn::TN;

constexpr int WARP_ROWS = 8;            // warp_bwd, da_sum: warps per block
constexpr int STAGE_LD = TM + 4;        // transposing stage: row stride
constexpr int REDUCE_THREADS = 256;
constexpr int SORT_THREADS = 512;       // da_sort
constexpr int SORT_SMEM_COUNTS = 8192;  // counts in shared memory up to T
constexpr unsigned FULL = 0xffffffffu;

// Per target row of a tile: what the softmax backward needs.
struct RowData {
  float mt, lse, flx, fly, gfx, gfy;
};

// The bilinear taps of one flow row as grid_sample takes them
// (align_corners=False, zeros outside): corner q is (y0 + q / 2,
// x0 + q % 2).
struct Taps {
  int xi, yi;
  float wx, wy;
  __device__ __forceinline__ Taps(const float* fl, int H, int W) {
    const float ix = ((fl[0] + 1.f) * W - 1.f) * 0.5f;
    const float iy = ((fl[1] + 1.f) * H - 1.f) * 0.5f;
    const float x0 = floorf(ix), y0 = floorf(iy);
    wx = ix - x0;
    wy = iy - y0;
    xi = (int)x0;
    yi = (int)y0;
  }
  // the source pixel of corner q, or -1 off the canvas
  __device__ __forceinline__ int pixel(int q, int H, int W) const {
    const int x = xi + (q & 1), y = yi + (q >> 1);
    return x >= 0 && x <= W - 1 && y >= 0 && y <= H - 1 ? y * W + x : -1;
  }
  __device__ __forceinline__ float weight(int q) const {
    return ((q >> 1) ? wy : 1.f - wy) * ((q & 1) ? wx : 1.f - wx);
  }
};

// ---- warp backward: gflow, one warp per row ------------------------------
template <bool VEC>
__global__ void __launch_bounds__(WARP_ROWS * 32) warp_bwd_kernel(
    const float* __restrict__ src,    // (G, S, T, C) un-normalised
    const float* __restrict__ flow,   // (G, S, F, T, 2)
    const float* __restrict__ gw,     // (G, S, F, T, C)
    const float* __restrict__ gf,     // (G, S, F, T, 2)
    float* __restrict__ gflow,        // (G, S, F, T, 2) out
    int F, int T, int C, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  const int pair = blockIdx.y;               // (g * S + s) * F + f
  if (t >= T) return;
  const int gs = pair / F;                   // g * S + s
  const size_t row = (size_t)pair * T + t;
  const float* a = src + (size_t)gs * T * C;
  const float* gwr = gw + row * C;

  const Taps tap(flow + 2 * row, H, W);
  const float wx = tap.wx, wy = tap.wy;
  // d weight / d ix and d weight / d iy of each corner
  const float dwx[4] = {-(1.f - wy), 1.f - wy, -wy, wy};
  const float dwy[4] = {-(1.f - wx), -wx, 1.f - wx, wx};
  int idx[4];
  bool in[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int u = tap.pixel(q, H, W);
    in[q] = u >= 0;
    idx[q] = in[q] ? u : 0;
  }

  float dot[4] = {0.f, 0.f, 0.f, 0.f};
  if (VEC) {  // C % 4 == 0, 16-byte aligned planes: 4 channels a lane
    for (int c = 4 * lane; c < C; c += 128) {
      const float4 g = *reinterpret_cast<const float4*>(gwr + c);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!in[q]) continue;
        const float4 v =
            *reinterpret_cast<const float4*>(a + (size_t)idx[q] * C + c);
        dot[q] = fmaf(g.x, v.x, dot[q]);
        dot[q] = fmaf(g.y, v.y, dot[q]);
        dot[q] = fmaf(g.z, v.z, dot[q]);
        dot[q] = fmaf(g.w, v.w, dot[q]);
      }
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      const float g = gwr[c];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!in[q]) continue;
        dot[q] = fmaf(g, a[(size_t)idx[q] * C + c], dot[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot[q] += __shfl_xor_sync(FULL, dot[q], off);
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

// ---- da, first: a stable counting sort by source pixel, a block a (g, s) --
__global__ void __launch_bounds__(SORT_THREADS) da_sort_kernel(
    const float* __restrict__ flow,  // (G, S, F, T, 2)
    int* __restrict__ keys,    // (G, S, N) scratch: item k's pixel, or -1
    int* __restrict__ ranks,   // (G, S, N) scratch: k's place in its bucket
    int* __restrict__ order,   // (G, S, N) out: the items, bucket by bucket
    int* __restrict__ offs,    // (G, S, T + 1) out: bucket u's range
    int F, int T, int H, int W, int smem_counts) {
  extern __shared__ int counts_smem[];
  __shared__ int warp_sums[SORT_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gs = blockIdx.x, N = 4 * F * T;
  const float* fl = flow + (size_t)gs * F * T * 2;
  int* key = keys + (size_t)gs * N;
  int* rank = ranks + (size_t)gs * N;
  int* ord = order + (size_t)gs * N;
  int* off = offs + (size_t)gs * (T + 1);
  int* cnt = smem_counts ? counts_smem : off;  // off is scanned in place

  for (int k = tid; k < N; k += SORT_THREADS)
    key[k] = Taps(fl + 2 * (k >> 2), H, W).pixel(k & 3, H, W);
  for (int u = tid; u < T; u += SORT_THREADS) cnt[u] = 0;
  __syncthreads();

  // ranks: one warp walks the items in k order, 32 at a time; a step's
  // equal keys rank among themselves by lane, after the earlier steps'
  if (warp == 0) {
    const unsigned below = (1u << lane) - 1u;
    int next = lane < N ? key[lane] : -1;
    for (int base = 0; base < N; base += 32) {
      const int k = base + lane, u = next;
      next = k + 32 < N ? key[k + 32] : -1;
      const unsigned peers = __match_any_sync(FULL, u);
      const int c = u >= 0 ? cnt[u] : 0;
      __syncwarp();
      if (u >= 0) {
        rank[k] = c + __popc(peers & below);
        if (lane == __ffs(peers) - 1) cnt[u] = c + __popc(peers);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // offsets: the exclusive scan of the counts, SORT_THREADS at a time
  int carry = 0;
  for (int u0 = 0; u0 < T; u0 += SORT_THREADS) {
    const int u = u0 + tid;
    const int v = u < T ? cnt[u] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < SORT_THREADS / 32; ++w) {
      const int sw = warp_sums[w];
      before += w < warp ? sw : 0;
      total += sw;
    }
    if (u < T) off[u] = carry + before + x - v;
    carry += total;
    __syncthreads();  // warp_sums and cnt are read before the next writes
  }
  if (tid == 0) off[T] = carry;
  __syncthreads();

  for (int k = tid; k < N; k += SORT_THREADS) {
    const int u = key[k];
    if (u >= 0) ord[off[u] + rank[k]] = k;
  }
}

// ---- da, second: each source pixel's bucket summed in order, a warp each --
template <bool VEC>
__global__ void __launch_bounds__(WARP_ROWS * 32) da_sum_kernel(
    const float* __restrict__ flow,   // (G, S, F, T, 2)
    const float* __restrict__ gw,     // (G, S, F, T, C)
    const int* __restrict__ order,    // (G, S, N) from da_sort
    const int* __restrict__ offs,     // (G, S, T + 1) from da_sort
    float* __restrict__ da,           // (G, S, T, C) out
    int F, int T, int C, int H, int W) {
  const int lane = threadIdx.x & 31;
  const int u = blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  const int gs = blockIdx.y;
  if (u >= T) return;
  const size_t row0 = (size_t)gs * F * T;      // the (g, s)'s first row
  const int* ord = order + row0 * 4;
  const int b = offs[(size_t)gs * (T + 1) + u];
  const int e = offs[(size_t)gs * (T + 1) + u + 1];
  float* out = da + ((size_t)gs * T + u) * C;
  if (VEC) {  // C % 4 == 0, 16-byte aligned planes: 4 channels a lane
    for (int c = 4 * lane; c < C; c += 128) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i = b; i < e; ++i) {
        const int k = ord[i];
        const size_t r = row0 + (k >> 2);
        const float wq = Taps(flow + 2 * r, H, W).weight(k & 3);
        const float4 g = *reinterpret_cast<const float4*>(gw + r * C + c);
        acc.x = fmaf(wq, g.x, acc.x);
        acc.y = fmaf(wq, g.y, acc.y);
        acc.z = fmaf(wq, g.z, acc.z);
        acc.w = fmaf(wq, g.w, acc.w);
      }
      *reinterpret_cast<float4*>(out + c) = acc;
    }
  } else {
    for (int c = lane; c < C; c += 32) {
      float acc = 0.f;
      for (int i = b; i < e; ++i) {
        const int k = ord[i];
        const size_t r = row0 + (k >> 2);
        acc = fmaf(Taps(flow + 2 * r, H, W).weight(k & 3), gw[r * C + c],
                   acc);
      }
      out[c] = acc;
    }
  }
}

// ---- logits: P, gL (twice) and the gK sums, one block per (pair, tile) ---
template <bool VEC>
__global__ void __launch_bounds__(tsnet_attn::THREADS, 2) logits_bwd_kernel(
    const float* __restrict__ src_n,     // (G, S, T, C)
    const float* __restrict__ src_mask,  // (G, S, T)
    const float* __restrict__ tar_n,     // (G, F, T, C)
    const float* __restrict__ tar_mask,  // (G, F, T)
    const float* __restrict__ grid,      // (T, 2)
    const float* __restrict__ flow,      // (G, S, F, T, 2)
    const float* __restrict__ lse,       // (G, S, F, T)
    const float* __restrict__ gflow,     // (G, S, F, T, 2)
    float* __restrict__ gl,              // (G, S, F, T, TP) out: [t][u]
    float* __restrict__ glt,             // (G, F, S, T, TP) out: [u][t]
    float* __restrict__ gmt_part,        // (G, S, F, T) out
    float* __restrict__ col_part,        // (G, S, F, NRT, T, 3) out
    int S, int F, int T, int C, int TP, float temp) {
  __shared__ __align__(16) tsnet_attn::Smem sm;
  __shared__ RowData rows[TM];
  __shared__ float red[tsnet_attn::THREADS / 32][TN][3];
  extern __shared__ __align__(16) float stage[];  // [TN][STAGE_LD]: gL^T

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * TM;
  const int pair = blockIdx.y;          // (g * S + s) * F + f
  const int f = pair % F, gs = pair / F;
  const int g = gs / S, s = gs % S;
  const int gf = g * F + f;
  const size_t prow = (size_t)pair * T;  // the pair's row 0
  const float* msp = src_mask + (size_t)gs * T;
  float* glt_p = glt + ((size_t)gf * S + s) * T * TP;

  for (int r = tid; r < TM; r += tsnet_attn::THREADS) {
    const int t = row0 + r;
    RowData d = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (t < T) {
      d.mt = tar_mask[(size_t)gf * T + t];
      d.lse = lse[prow + t];
      d.flx = flow[2 * (prow + t)];
      d.fly = flow[2 * (prow + t) + 1];
      d.gfx = gflow[2 * (prow + t)];
      d.gfy = gflow[2 * (prow + t) + 1];
    }
    rows[r] = d;
  }
  // rows[] is read in the epilogues, after the chunk loop's first barrier

  float gmt_acc[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) gmt_acc[i] = 0.f;

  tsnet_attn::for_each_logit_chunk<VEC>(
      tar_n + (size_t)gf * T * C, src_n + (size_t)gs * T * C, row0, T, T, C,
      sm, [&](const float (&acc)[RM][RN], int col0) {
        float msk[RN], gx[RN], gy[RN], cgm[RN], cgx[RN], cgy[RN];
        bool ok[RN];
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const int u = col0 + tile_col(tx, j);
          ok[j] = u < T;
          msk[j] = ok[j] ? msp[u] : 0.f;
          gx[j] = ok[j] ? grid[2 * u] : 0.f;
          gy[j] = ok[j] ? grid[2 * u + 1] : 0.f;
          cgm[j] = cgx[j] = cgy[j] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const int r = tile_row(ty, i);
          const bool row_ok = row0 + r < T;
          const RowData rd = rows[r];
          const float sm_t = 2.f * rd.mt - 1.f;
          float* gl_row = gl + (prow + row0 + r) * TP + col0;
#pragma unroll
          for (int j = 0; j < RN; ++j) {
            const float coeff = rd.mt * msk[j] + (1.f - rd.mt) * (1.f - msk[j]);
            const float z = temp * (acc[i][j] * coeff);
            const float p = (ok[j] && row_ok) ? expf(z - rd.lse) : 0.f;
            const float gz =
                p * (rd.gfx * (gx[j] - rd.flx) + rd.gfy * (gy[j] - rd.fly));
            const float gk = temp * acc[i][j] * gz;
            const float glv = temp * coeff * gz;
            gmt_acc[i] = fmaf(gk, 2.f * msk[j] - 1.f, gmt_acc[i]);
            cgm[j] = fmaf(gk, sm_t, cgm[j]);
            cgx[j] = fmaf(p, rd.gfx, cgx[j]);
            cgy[j] = fmaf(p, rd.gfy, cgy[j]);
            if (ok[j] && row_ok) gl_row[tile_col(tx, j)] = glv;
            stage[tile_col(tx, j) * STAGE_LD + r] = glv;
          }
        }
        // column sums: the two row groups of the warp, then the warps
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          cgm[j] += __shfl_xor_sync(0xffffffffu, cgm[j], 16);
          cgx[j] += __shfl_xor_sync(0xffffffffu, cgx[j], 16);
          cgy[j] += __shfl_xor_sync(0xffffffffu, cgy[j], 16);
          if (lane < 16) {
            red[warp][tile_col(tx, j)][0] = cgm[j];
            red[warp][tile_col(tx, j)][1] = cgx[j];
            red[warp][tile_col(tx, j)][2] = cgy[j];
          }
        }
        __syncthreads();
        // column tid of the chunk: its per-(pair, row tile) partials
        if (col0 + tid < T) {
          float* cp = col_part +
                      (((size_t)pair * gridDim.x + blockIdx.x) * T + col0 +
                       tid) * 3;
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float v = red[0][tid][k];
#pragma unroll
            for (int w = 1; w < tsnet_attn::THREADS / 32; ++w)
              v += red[w][tid][k];
            cp[k] = v;
          }
        }
        // gL^T rows u = col0.., 64 targets each, 16 bytes a store
        for (int e = tid; e < TN * TM / 4; e += tsnet_attn::THREADS) {
          const int u = e / (TM / 4), q = 4 * (e % (TM / 4));
          if (col0 + u < T && row0 + q < T)
            *reinterpret_cast<float4*>(glt_p + (size_t)(col0 + u) * TP +
                                       row0 + q) =
                *reinterpret_cast<const float4*>(&stage[u * STAGE_LD + q]);
        }
        // the next chunk's epilogue writes red and stage after the chunk
        // loop's next barrier
      });

  // gmt: merge the 16 column owners of each row (lanes that differ in tx)
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      gmt_acc[i] += __shfl_xor_sync(0xffffffffu, gmt_acc[i], off);
    const int t = row0 + tile_row(ty, i);
    if (tx == 0 && t < T) gmt_part[prow + t] = gmt_acc[i];
  }
}

// ---- gtn and gsn: k-major fp32 GEMMs over the stored gL ------------------
template <bool VEC>
__global__ void __launch_bounds__(tsnet_sgemm::THREADS, 2) gemm_kernel(
    tsnet_sgemm::Operand a, tsnet_sgemm::Operand b, float* __restrict__ out,
    long long sc1, long long sc2, int ldc, int M, int N, int K, int nb2) {
  __shared__ __align__(16) tsnet_sgemm::Smem sm;
  tsnet_sgemm::gemm_tile<VEC>(a, b, out, sc1, sc2, ldc, M, N, K, nb2, sm);
}

// ---- the partial sums, in a fixed order ---------------------------------
__global__ void __launch_bounds__(REDUCE_THREADS) reduce_bwd_kernel(
    const float* __restrict__ gmt_part,  // (G, S, F, T)
    const float* __restrict__ col_part,  // (G, S, F, NRT, T, 3)
    float* __restrict__ gmt,             // (G, F, T) out
    float* __restrict__ gms,             // (G, S, T) out
    float* __restrict__ gg_part,         // (G, S, T, 2) out
    int G, int S, int F, int T, int NRT) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i < G * F * T) {  // gmt[g, f, t] = sum_s gmt_part[g, s, f, t]
    const int t = i % T, gf = i / T, f = gf % F, g = gf / F;
    float v = 0.f;
    for (int s = 0; s < S; ++s)
      v += gmt_part[((size_t)(g * S + s) * F + f) * T + t];
    gmt[i] = v;
  }
  if (i < G * S * T) {  // gms, ggrid partial of (g, s) at source pixel u
    const int u = i % T, gs = i / T;
    float v[3] = {0.f, 0.f, 0.f};
    for (int f = 0; f < F; ++f)
      for (int rt = 0; rt < NRT; ++rt) {
        const float* cp =
            col_part + ((((size_t)gs * F + f) * NRT + rt) * T + u) * 3;
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] += cp[k];
      }
    gms[i] = v[0];
    gg_part[2 * (size_t)i] = v[1];
    gg_part[2 * (size_t)i + 1] = v[2];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<size_t>(p) % 16 == 0;
}

template <bool VEC>
cudaError_t launch_gemm(tsnet_sgemm::Operand a, tsnet_sgemm::Operand b,
                        float* out, long long sc1, long long sc2, int M,
                        int N, int K, int nb1, int nb2, cudaStream_t st) {
  const dim3 blocks((N + tsnet_sgemm::BN - 1) / tsnet_sgemm::BN,
                    (M + tsnet_sgemm::BM - 1) / tsnet_sgemm::BM, nb1 * nb2);
  gemm_kernel<VEC><<<blocks, tsnet_sgemm::THREADS, 0, st>>>(
      a, b, out, sc1, sc2, N, M, N, K, nb2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every pointer is a contiguous f32 tensor on the device but da_part,
// int32. Scratch: gflow of the shape of flow; da_part 3 G*S*N + G*S*(T + 1)
// ints with N = 4 F T (da_sort's keys, ranks, order and offsets); gl
// (G, S, F, T, TP) and glt (G, F, S, T, TP) with TP = T rounded up to a
// multiple of 4; gmt_part (G, S, F, T); col_part (G, S, F, NRT, T, 3) with
// NRT = ceil(T / 64). `phases` selects the launches by bit (1 warp_bwd,
// 2 da_sort, 4 da_sum, 8 logits, 16 gtn, 32 gsn, 64 reduce; 127 all), so
// that each can be timed alone once the launches before it have run.
int tsnet_transform_warp_bwd(
    const void* src, const void* src_n, const void* src_mask,
    const void* tar_n, const void* tar_mask, const void* grid,
    const void* flow, const void* lse, const void* gw, const void* gf,
    void* gflow, void* da, void* gtn, void* gsn, void* gmt, void* gms,
    void* gg_part, void* da_part, void* gl, void* glt, void* gmt_part,
    void* col_part, int G, int S, int F, int T, int C, int H, int W,
    float temp, int phases, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* fsrc_n = static_cast<const float*>(src_n);
  const float* ftar_n = static_cast<const float*>(tar_n);
  const float* fflow = static_cast<const float*>(flow);
  const float* fgw = static_cast<const float*>(gw);
  float* fgl = static_cast<float*>(gl);
  float* fglt = static_cast<float*>(glt);
  const int TP = (T + 3) / 4 * 4;
  const int NRT = (T + TM - 1) / TM;
  const size_t items = (size_t)G * S * 4 * F * T;
  int* keys = static_cast<int*>(da_part);
  int* ranks = keys + items;
  int* order = ranks + items;
  int* offs = order + items;
  cudaError_t e = cudaSuccess;

  if (phases & 1) {
    const dim3 blocks((T + WARP_ROWS - 1) / WARP_ROWS, G * S * F);
    const bool vec = C % 4 == 0 && aligned16(src) && aligned16(gw);
    auto kernel = vec ? warp_bwd_kernel<true> : warp_bwd_kernel<false>;
    kernel<<<blocks, WARP_ROWS * 32, 0, st>>>(
        static_cast<const float*>(src), fflow, fgw,
        static_cast<const float*>(gf), static_cast<float*>(gflow), F, T, C,
        H, W);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (phases & 2) {
    const int smem_counts = T <= SORT_SMEM_COUNTS;
    da_sort_kernel<<<G * S, SORT_THREADS,
                     smem_counts ? T * sizeof(int) : 0, st>>>(
        fflow, keys, ranks, order, offs, F, T, H, W, smem_counts);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (phases & 4) {
    const dim3 blocks((T + WARP_ROWS - 1) / WARP_ROWS, G * S);
    const bool vec = C % 4 == 0 && aligned16(gw) && aligned16(da);
    auto kernel = vec ? da_sum_kernel<true> : da_sum_kernel<false>;
    kernel<<<blocks, WARP_ROWS * 32, 0, st>>>(
        fflow, fgw, order, offs, static_cast<float*>(da), F, T, C, H, W);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (phases & 8) {
    auto kernel = tsnet_attn::vector_loads(C, src_n, tar_n)
                      ? logits_bwd_kernel<true>
                      : logits_bwd_kernel<false>;
    const size_t dyn = (size_t)TN * STAGE_LD * sizeof(float);
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
    if (e != cudaSuccess) {
      cudaGetLastError();  // clear it, so the next launch reports its own
      return (int)e;
    }
    kernel<<<dim3(NRT, G * S * F), tsnet_attn::THREADS, dyn, st>>>(
        fsrc_n, static_cast<const float*>(src_mask), ftar_n,
        static_cast<const float*>(tar_mask), static_cast<const float*>(grid),
        fflow, static_cast<const float*>(lse),
        static_cast<const float*>(gflow), fgl, fglt,
        static_cast<float*>(gmt_part), static_cast<float*>(col_part), S, F,
        T, C, TP, temp);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const long long TT = (long long)T * TP, TC = (long long)T * C;
  if (phases & 16) {  // gtn per (g, f): A = glt rows (s, u), B = sn rows
    const tsnet_sgemm::Operand a = {fglt, F * S * TT, S * TT, TP};
    const tsnet_sgemm::Operand b = {fsrc_n, S * TC, 0, C};
    e = tsnet_attn::vector_loads(C, src_n, gtn)
            ? launch_gemm<true>(a, b, static_cast<float*>(gtn), F * TC, TC, T,
                                C, S * T, G, F, st)
            : launch_gemm<false>(a, b, static_cast<float*>(gtn), F * TC, TC,
                                 T, C, S * T, G, F, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (phases & 32) {  // gsn per (g, s): A = gl rows (f, t), B = tn rows
    const tsnet_sgemm::Operand a = {fgl, S * F * TT, F * TT, TP};
    const tsnet_sgemm::Operand b = {ftar_n, F * TC, 0, C};
    e = tsnet_attn::vector_loads(C, tar_n, gsn)
            ? launch_gemm<true>(a, b, static_cast<float*>(gsn), S * TC, TC, T,
                                C, F * T, G, S, st)
            : launch_gemm<false>(a, b, static_cast<float*>(gsn), S * TC, TC,
                                 T, C, F * T, G, S, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (phases & 64) {
    const int n = G * T * (S > F ? S : F);
    reduce_bwd_kernel<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS,
                        REDUCE_THREADS, 0, st>>>(
        static_cast<const float*>(gmt_part),
        static_cast<const float*>(col_part), static_cast<float*>(gmt),
        static_cast<float*>(gms), static_cast<float*>(gg_part), G, S, F, T,
        NRT);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

const char* tsnet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
