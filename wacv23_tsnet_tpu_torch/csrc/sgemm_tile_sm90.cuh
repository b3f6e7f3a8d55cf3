// A register-blocked GEMM tile for Hopper (sm_90a) over k-major fp32
// operands, for the flash backward's two products (transform_warp_bwd.cu):
//
//   out[m][n] = sum_k a[k][m] * b[k][n]
//
// with a (K, M) and b (K, N) both row-major (k-major: a row of a holds the
// M values of one k, a row of b the N values), out (M, N) row-major. A
// batch index (b1, b2) selects each operand by two strides, so one launch
// covers e.g. every (group, frame) of gtn = sum_s gL_s^T sn_s.
//
// Precision: 3xTF32. Each fp32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), and a b ~ a_hi b_lo + a_lo b_hi + a_hi b_hi on the
// tensor cores (mma.sync m16n8k8 tf32, fp32 accumulation): about fp32
// accuracy (PERF.md has the backward's measured errors against float64)
// at three tensor-core products per product.
// Only these two products take it: the logits stay fp32 FFMAs, since temp
// 100 multiplies any logit error by 100 inside exp.
//
// The tile: 128 x 128 outputs a block, 256 threads in 8 warps, 2 along M
// x 4 along N, each with a 64 x 32 warp tile of 4 x 4 m16n8 tiles (64
// fp32 accumulators a thread). Depth slices of BK = 16 rows of a and of b
// are copied by cp.async, 16 bytes a copy (zero-filled past M, N and K),
// into a double buffer: the copies of slice k + 1 are in flight during
// the MMAs on slice k, one __syncthreads() a slice. Rows are stored as
// they are in memory at a stride of 136 floats, so each fragment load (a
// thread reads a[k0 + t][m + g], g and t its lane's group and rank) hits
// 32 distinct banks. 34 KB of static shared memory a block,
// __launch_bounds__(256, 2): two blocks an SM at up to 128 registers.
//
// Operand a must have a leading dimension that is a multiple of 4 floats
// and a 16-byte aligned base (the backward pads its gL rows to that); b may
// not (VEC = false then copies b 4 bytes at a time and stores out by
// scalars). Columns m of a up to the next multiple of 4 are read but only
// feed rows of out past M, which are not stored.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tsnet_sgemm {

constexpr int BM = 128;        // output rows per block
constexpr int BN = 128;        // output columns per block
constexpr int BK = 16;         // depth per slice
constexpr int THREADS = 256;   // 8 warps, 2 along M x 4 along N
constexpr int LD = BM + 8;     // row stride in shared memory

struct Smem {
  float a[2][BK][LD];
  float b[2][BK][LD];
};

struct Operand {
  const float* p;    // batch (0, 0), row 0
  long long s1, s2;  // batch strides, in floats
  int ld;            // row stride, in floats
};

__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// x rounded to tf32 (10 mantissa bits, to nearest), as a tf32 register
__device__ __forceinline__ uint32_t tf32_of(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for one m16n8k8 tile, tf32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Start the copies of slice k0.. of a (columns m0..) and b (columns n0..):
// piece p of a slice's 512 16-byte pieces is row p / 32, columns
// 4 (p % 32).., so a warp copies one 512-byte row an instruction.
template <bool VEC>
__device__ __forceinline__ void load_slice(float (*sa)[LD], float (*sb)[LD],
                                           const float* __restrict__ a,
                                           int lda,
                                           const float* __restrict__ b,
                                           int ldb, int k0, int m0, int n0,
                                           int M, int N, int K) {
#pragma unroll
  for (int n = 0; n < BK * BM / 4 / THREADS; ++n) {
    const int p = threadIdx.x + n * THREADS;
    const int r = p / (BM / 4), q = 4 * (p % (BM / 4));
    const bool ok = k0 + r < K && m0 + q < M;
    cp16(&sa[r][q], ok ? a + (size_t)(k0 + r) * lda + m0 + q : a, ok);
  }
#pragma unroll
  for (int n = 0; n < BK * BN / 4 / THREADS; ++n) {
    const int p = threadIdx.x + n * THREADS;
    const int r = p / (BN / 4), q = 4 * (p % (BN / 4));
    const bool row_ok = k0 + r < K;
    const float* src = b + (size_t)(row_ok ? k0 + r : 0) * ldb + n0 + q;
    if (VEC) {  // N % 4 == 0, ldb % 4 == 0, 16-byte aligned base
      const bool ok = row_ok && n0 + q < N;
      cp16(&sb[r][q], ok ? src : b, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = row_ok && n0 + q + j < N;
        cp4(&sb[r][q + j], ok ? src + j : b, ok);
      }
    }
  }
}

// One block's 128 x 128 tile of out = a^T b for batch (blockIdx.z / nb2,
// blockIdx.z % nb2), rows blockIdx.y, columns blockIdx.x. Every thread of
// the block calls it.
template <bool VEC>
__device__ __forceinline__ void gemm_tile(Operand A, Operand B, float* out,
                                          long long sc1, long long sc2,
                                          int ldc, int M, int N, int K,
                                          int nb2, Smem& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int b1 = blockIdx.z / nb2, b2 = blockIdx.z % nb2;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float* a = A.p + b1 * A.s1 + b2 * A.s2;
  const float* b = B.p + b1 * B.s1 + b2 * B.s2;
  out += b1 * sc1 + b2 * sc2;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int slices = (K + BK - 1) / BK;
  load_slice<VEC>(sm.a[0], sm.b[0], a, A.ld, b, B.ld, 0, m0, n0, M, N, K);
  for (int sl = 0; sl < slices; ++sl) {
    wait_all();       // this thread's copies of slice sl
    __syncthreads();  // everyone's; and the other buffer is free
    if (sl + 1 < slices)
      load_slice<VEC>(sm.a[(sl + 1) & 1], sm.b[(sl + 1) & 1], a, A.ld, b,
                      B.ld, (sl + 1) * BK, m0, n0, M, N, K);
    const float (*sa)[LD] = sm.a[sl & 1];
    const float (*sb)[LD] = sm.b[sl & 1];
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + 16 * i + g;
        const float v[4] = {sa[k0 + t][m], sa[k0 + t][m + 8],
                            sa[k0 + t + 4][m], sa[k0 + t + 4][m + 8]};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          ah[i][q] = tf32_of(v[q]);
          al[i][q] = tf32_of(v[q] - __uint_as_float(ah[i][q]));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn * 32 + 8 * j + g;
        const float v[2] = {sb[k0 + t][n], sb[k0 + t + 4][n]};
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          bh[j][q] = tf32_of(v[q]);
          bl[j][q] = tf32_of(v[q] - __uint_as_float(bh[j][q]));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(acc[i][j], ah[i], bl[j]);
          mma_tf32(acc[i][j], al[i], bh[j]);
          mma_tf32(acc[i][j], ah[i], bh[j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + 16 * i + g + 8 * h;
      if (m >= M) continue;
      float* row = out + (size_t)m * ldc;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + 8 * j + 2 * t;
        if (VEC) {
          if (n < N)
            *reinterpret_cast<float2*>(row + n) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        } else {
          if (n < N) row[n] = acc[i][j][2 * h];
          if (n + 1 < N) row[n + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
}

}  // namespace tsnet_sgemm
