// The fp32 attention-logit tile of TS-Net's masked attention for Hopper
// (sm_90a), shared by csrc/transform_warp.cu (K1, K3-nf, K3-flow) and
// csrc/attention_flow.cu (K5). For one block's TM target rows and one
// source plane it streams every source row (column) past the target rows
// and leaves, per row, the online softmax of
//   z[t, u] = temp * (<tar[t], src[u]> * (mt*ms + (1-mt)(1-ms)))
// over all columns: the running max m, the sum l of exp(z - m) and the
// flow numerator (fx, fy) = sum exp(z - m) * grid[u]. A cross-region pair
// gets logit 0, not -inf. Rows past n_rows, columns past n_cols and
// channels past C are zero-filled and masked, so any shape runs.
//
// What bounds it: fp32 FMAs. The logits must keep fp32 accuracy (temp 100
// turns a logit error into 100 times that inside exp), so they are FFMAs
// on the CUDA cores, never TF32, bf16 or 3xTF32 tensor-core products; at
// T = S = 1024, C = 512 they are ~99% of the work and the bytes are small.
// Beside the FMA pipes, two things can set the pace: the shared-memory
// reads that feed the FMAs, and the instructions and latency of loading
// the next chunk. The tile does this about them:
//
// - Register blocking: 128 threads (8 x 16) each own an 8 x 8 block of
//   the 64 x 128 logit tile (rows ty + 8i, columns tx + 16j). Shared memory
//   holds each chunk row-major, a row's KC = 16 channels contiguous at a
//   stride of LD = 20 floats; per 4 channels a thread reads its 8 target
//   and 8 source fragments as 16-byte loads (LDS.128) and runs 256
//   FFMAs, 16 for each load. The source reads of a half-warp (16 rows
//   tx + 16j) fall on distinct bank quads but for rows 8 apart, so they
//   take the two wavefronts their 256 bytes need; the target reads are
//   broadcasts.
// - Double-buffered asynchronous loads: while the FMAs run on one chunk
//   (64 target and 128 source rows x 16 channels), cp.async copies the
//   next one into the other buffer, 16 bytes a copy, with zero-fill past
//   the edges; one __syncthreads() a chunk. No staging registers and no
//   shared stores: a thread starts six copies a chunk. A transposing
//   loader staged through registers (LDG.128, then STS.128 channel-major)
//   spent far more instructions on each chunk, 32 registers on the staged
//   chunk, and ran the same FMAs a quarter slower on the H100 (PERF.md).
//   Where C % 4 != 0 or a plane is not 16-byte aligned, the same kernel
//   copies 4 bytes at a time (VEC = false).
// - Each logit is one chain of fp32 FMAs over channels 0..C-1 in order,
//   from 0: the same value, bit for bit, in every kernel that streams
//   chunks through this tile, the flash backward (transform_warp_bwd.cu,
//   through for_each_logit_chunk) among them. The softmax sums run
//   in another order (each thread over its 8 columns of every 128-column
//   chunk, then a butterfly across the 16 column owners), so l, and the
//   log-sum-exp and flow made from it, differ from a sequential sum's in
//   the last bits.
// - The 16 column owners of a row are the 16 lanes of one half-warp; after
//   the last chunk they merge their statistics with __shfl_xor_sync, and
//   every lane of the half then holds all 8 rows (lane tx writes row tx in
//   the kernels' epilogues).
//
// Per block: 30 KB of static shared memory and up to 255 registers a
// thread (__launch_bounds__(128, 2): two blocks, eight warps, an SM).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tsnet_attn {

constexpr int TM = 64;        // target rows per block
constexpr int TN = 128;       // source rows (logit columns) per chunk
constexpr int KC = 16;        // channels per chunk
constexpr int LD = KC + 4;    // row stride of a chunk in shared memory
constexpr int THREADS = 128;  // 8 x 16 threads
constexpr int RM = 8;         // logit rows per thread
constexpr int RN = 8;         // logit columns per thread

struct Smem {
  float a[2][TM][LD];  // target chunk, row-major, two buffers
  float b[2][TN][LD];  // source chunk, row-major, two buffers
};

// One row's online softmax: running max, sum and flow numerator.
struct RowStats {
  float m[RM], l[RM], fx[RM], fy[RM];
};

// Tile row of a thread's i-th logit row, tile column of its j-th column.
__device__ __forceinline__ int tile_row(int ty, int i) { return ty + 8 * i; }
__device__ __forceinline__ int tile_col(int tx, int j) { return tx + 16 * j; }

// Copy 16 bytes (or 4) from global to shared memory asynchronously;
// zeros where `valid` is false (src is then not read).
__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
// Wait for every copy this thread has started.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Start the copies of one chunk: channels k0..k0+KC-1 of rows row0.. of
// tar (n_rows, C) and col0.. of src (n_cols, C) into (a, b). Piece p of
// the 4-channel pieces is row p / 4, channels 4 (p % 4).., so a warp
// copies 8 rows x 64 contiguous bytes an instruction.
template <bool VEC>
__device__ __forceinline__ void load_chunk(
    float (*a)[LD], float (*b)[LD], const float* __restrict__ tar,
    const float* __restrict__ src, int row0, int col0, int k0, int n_rows,
    int n_cols, int C) {
  constexpr int A_PIECES = TM * KC / 4, PIECES = (TM + TN) * KC / 4;
  static_assert(A_PIECES % THREADS == 0 && PIECES % THREADS == 0, "");
#pragma unroll
  for (int n = 0; n < PIECES / THREADS; ++n) {
    const bool is_a = n < A_PIECES / THREADS;
    const int p = threadIdx.x + n * THREADS - (is_a ? 0 : A_PIECES);
    const int r = p / (KC / 4), q = 4 * (p % (KC / 4));
    const int gr = (is_a ? row0 : col0) + r;
    const bool row_ok = gr < (is_a ? n_rows : n_cols);
    const float* g = (is_a ? tar : src) + (size_t)(row_ok ? gr : 0) * C;
    float* s = is_a ? &a[r][q] : &b[r][q];
    if (VEC) {  // C % 4 == 0 and both planes 16-byte aligned
      const bool ok = row_ok && k0 + q < C;
      cp_async_16(s, ok ? g + k0 + q : g, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && k0 + q + j < C;
        cp_async_4(s + j, ok ? g + k0 + q + j : g, ok);
      }
    }
  }
}

// acc += the chunk's KC channels of the thread's 8 x 8 logits, each
// accumulator in channel order.
__device__ __forceinline__ void fma_chunk(const float (*a)[LD],
                                          const float (*b)[LD], int ty, int tx,
                                          float (&acc)[RM][RN]) {
#pragma unroll
  for (int kq = 0; kq < KC; kq += 4) {
    float4 av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      av[i] = *reinterpret_cast<const float4*>(&a[tile_row(ty, i)][kq]);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&b[tile_col(tx, j)][kq]);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
  }
}

// Fold one chunk's finished logits into the thread's online softmax.
__device__ __forceinline__ void softmax_update(
    const float (&acc)[RM][RN], const float (&mt)[RM],
    const float* __restrict__ ms, const float* __restrict__ grid, int col0,
    int n_cols, int tx, float temp, RowStats& st) {
  float msk[RN], gx[RN], gy[RN];
  bool ok[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int u = col0 + tile_col(tx, j);
    ok[j] = u < n_cols;
    msk[j] = ok[j] ? ms[u] : 0.f;
    gx[j] = ok[j] ? grid[2 * u] : 0.f;
    gy[j] = ok[j] ? grid[2 * u + 1] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    float z[RN];
    float zmax = st.m[i];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const float coeff = mt[i] * msk[j] + (1.f - mt[i]) * (1.f - msk[j]);
      z[j] = temp * (acc[i][j] * coeff);
      if (ok[j]) zmax = fmaxf(zmax, z[j]);
    }
    if (zmax == -INFINITY) continue;  // no valid column yet
    const float scale = expf(st.m[i] - zmax);
    st.l[i] *= scale;
    st.fx[i] *= scale;
    st.fy[i] *= scale;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      if (!ok[j]) continue;
      const float p = expf(z[j] - zmax);
      st.l[i] += p;
      st.fx[i] = fmaf(p, gx[j], st.fx[i]);
      st.fy[i] = fmaf(p, gy[j], st.fy[i]);
    }
    st.m[i] = zmax;
  }
}

// Merge the 16 column owners of each row: the lanes of a half-warp.
__device__ __forceinline__ void merge_rows(RowStats& st) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, st.m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, st.l[i], off);
      const float xo = __shfl_xor_sync(0xffffffffu, st.fx[i], off);
      const float yo = __shfl_xor_sync(0xffffffffu, st.fy[i], off);
      const float mn = fmaxf(st.m[i], mo);
      if (mn == -INFINITY) continue;
      const float a = expf(st.m[i] - mn), b = expf(mo - mn);
      st.l[i] = st.l[i] * a + lo * b;
      st.fx[i] = st.fx[i] * a + xo * b;
      st.fy[i] = st.fy[i] * a + yo * b;
      st.m[i] = mn;
    }
  }
}

// Stream every source row (column) of src (n_cols, C) past the block's
// rows row0.. of tar (n_rows, C), TN columns at a time: once a chunk's
// logits are complete, every thread calls epilogue(acc, col0) with its
// 8 x 8 block of them (rows tile_row(ty, i), columns col0 + tile_col(tx, j);
// zero past n_rows, n_cols). Every thread of the block calls it; each step
// of the loop starts with a __syncthreads(), so shared memory that an
// epilogue writes is safe to rewrite in the next one. On return the shared
// buffers are free again.
template <bool VEC, class Epilogue>
__device__ __forceinline__ void for_each_logit_chunk(
    const float* __restrict__ tar, const float* __restrict__ src, int row0,
    int n_rows, int n_cols, int C, Smem& sm, Epilogue epilogue) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int ksteps = (C + KC - 1) / KC;
  const int steps = ((n_cols + TN - 1) / TN) * ksteps;
  load_chunk<VEC>(sm.a[0], sm.b[0], tar, src, row0, 0, 0, n_rows, n_cols, C);
  int col0 = 0, ks = 0;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();  // this thread's copies of chunk `step`
    __syncthreads();      // everyone's; and the other buffer is free
    if (step + 1 < steps) {  // chunk step + 1, in flight during the FMAs
      const bool next_col = ks + 1 == ksteps;
      load_chunk<VEC>(sm.a[(step + 1) & 1], sm.b[(step + 1) & 1], tar, src,
                      row0, next_col ? col0 + TN : col0,
                      next_col ? 0 : (ks + 1) * KC, n_rows, n_cols, C);
    }
    fma_chunk(sm.a[step & 1], sm.b[step & 1], ty, tx, acc);
    if (++ks == ksteps) {
      epilogue(acc, col0);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
      ks = 0;
      col0 += TN;
    }
  }
  __syncthreads();  // the buffers are free for the next call
}

// The softmax statistics of the block's rows row0.. of tar (n_rows, C)
// over every row of src (n_cols, C), with mt the thread's rows' target
// mask, ms (n_cols) the source mask and grid (n_cols, 2). Every thread of
// the block calls it; on return each lane holds its 8 rows' merged
// statistics, and the shared buffers are free again.
template <bool VEC>
__device__ __forceinline__ void attend(
    const float* __restrict__ tar, const float* __restrict__ src,
    const float* __restrict__ ms, const float* __restrict__ grid,
    const float (&mt)[RM], int row0, int n_rows, int n_cols, int C,
    float temp, Smem& sm, RowStats& st) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
    st.fx[i] = 0.f;
    st.fy[i] = 0.f;
  }
  for_each_logit_chunk<VEC>(
      tar, src, row0, n_rows, n_cols, C, sm,
      [&](const float (&acc)[RM][RN], int col0) {
        softmax_update(acc, mt, ms, grid, col0, n_cols, tx, temp, st);
      });
  merge_rows(st);
}

// True where the 16-byte copies may read these (n, C) planes.
__host__ __forceinline__ bool vector_loads(int C, const void* a,
                                           const void* b) {
  return C % 4 == 0 && reinterpret_cast<size_t>(a) % 16 == 0 &&
         reinterpret_cast<size_t>(b) % 16 == 0;
}

}  // namespace tsnet_attn
