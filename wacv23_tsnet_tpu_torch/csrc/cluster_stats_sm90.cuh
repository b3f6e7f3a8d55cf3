// Instance-norm statistics finished inside a thread-block cluster (sm_90a),
// shared by conv3x3_in.cu (K7) and in_mean.cu (K2).
//
// A plane's pixels are split over the blocks of one cluster. Each block
// puts its per-channel partial sums in its own shared memory, sum[ch] and
// sum of squares[nch + ch], summed over its pixels in a fixed order. After
// cluster_sync every block reads every block's partials through
// distributed shared memory, in rank order, so all blocks form the same
// mean and rstd, and a run gives the same bits as the last: one-pass fp32,
// var = max(E[x^2] - E[x]^2, 0), eps inside the rsqrt. A block's partials
// must stay put until every block of the cluster has read them: a second
// cluster_sync (or the next write's own) orders that.

#pragma once

#include <cooperative_groups.h>

namespace cstats {

namespace cg = cooperative_groups;

__device__ __forceinline__ void cluster_sync() { cg::this_cluster().sync(); }

__device__ __forceinline__ unsigned cluster_rank() {
  return cg::this_cluster().block_rank();
}

// {mean, rstd} from a sum and a sum of squares over `count` values; the
// two-pass paths use it on sums over the whole plane too.
__device__ __forceinline__ float2 stats_of(float sum, float sq, float count,
                                           float eps) {
  const float mean = sum / count;
  // E[x^2]-E[x]^2 can cancel below 0 for a near-constant channel
  // (no FMA contraction: every kernel rounds this the same way)
  const float var = fmaxf(sq / count - __fmul_rn(mean, mean), 0.f);
  return make_float2(mean, rsqrtf(var + eps));
}

// The normalised value of v with {mean, rstd} st, relu'd on request; the
// product is rounded before any add that follows (no FMA contraction), as
// the plain versions round it.
__device__ __forceinline__ float normed(float v, float2 st, bool relu) {
  const float r = __fmul_rn(v - st.x, st.y);
  return relu ? fmaxf(r, 0.f) : r;
}

// The sum of part[i] over every block of the cluster, in rank order.
__device__ __forceinline__ float cluster_total(float* part, int i) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned blocks = cluster.num_blocks();
  float sum = 0.f;
  for (unsigned r = 0; r < blocks; ++r)
    sum += cluster.map_shared_rank(part, r)[i];
  return sum;
}

// {mean, rstd} of channel ch over `count` values, from the partials at
// part (sums) and part + nch (sums of squares) in every block of the
// cluster.
__device__ __forceinline__ float2 cluster_stats(float* part, int nch, int ch,
                                                float count, float eps) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned blocks = cluster.num_blocks();
  float sum = 0.f, sq = 0.f;
  for (unsigned r = 0; r < blocks; ++r) {
    const float* remote = cluster.map_shared_rank(part, r);
    sum += remote[ch];
    sq += remote[nch + ch];
  }
  return stats_of(sum, sq, count, eps);
}

}  // namespace cstats
