// A group's G-ary lower bound over a sorted int32 column: each round the
// group's G lanes (a warp by default) probe G - 1 pivots (or every id of a
// range of at most G) and one ballot narrows the range, so a run of n ids
// takes about log_G(n) dependent rounds where a binary search takes
// log2(n). Shared by the bs step's tile path (tile.cuh), the semidense
// phrase route's recovery (phrase_route.cu) and the verification's
// recovery from kept docs (phrase.cu), with the fixed-count search whose
// posting indices that recovery must equal (search_fixed, recover).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wiser_bound {

// log2 of a group's lanes (8 or 32)
template <int G>
__host__ __device__ constexpr int group_shift() {
  static_assert(G == 8 || G == 32, "a group of 8 or 32 lanes");
  return G == 8 ? 3 : 5;
}

// One round of a group's G-ary lower bound in [lo, hi): the probe this
// lane makes (-1: none). Above G ids, G - 1 pivots lo + n(i+1)/G split the
// range; at most G, each id is probed.
template <int G = 32>
__device__ __forceinline__ long long probe_at(long long lo, long long hi,
                                              int lane) {
  const long long n = hi - lo;
  if (n <= 0) return -1;
  if (n <= G) return lane < n ? lo + lane : -1;
  return lane < G - 1 ? lo + ((n * (lane + 1)) >> group_shift<G>()) : -1;
}

// narrow [lo, hi) given c, the number of this round's probes below target
template <int G = 32>
__device__ __forceinline__ void narrow(long long& lo, long long& hi, int c) {
  const long long n = hi - lo;
  if (n <= 0) return;
  if (n <= G) {
    lo += c;
    hi = lo;
    return;
  }
  const long long l0 = lo;
  if (c > 0) lo = l0 + ((n * c) >> group_shift<G>()) + 1;
  if (c < G - 1) hi = l0 + ((n * (c + 1)) >> group_shift<G>());
}

// The lower bound of target in the sorted ids [lo, hi) of the column, by
// one group of G lanes (lane its lane in the group, mask the group's
// lanes; uniform result). Reads only inside [lo, hi).
template <int G = 32>
__device__ __forceinline__ long long warp_lower_bound(
    const int32_t* doc, long long lo, long long hi, long long target,
    int lane, unsigned mask = 0xffffffffu) {
  while (hi > lo) {
    const long long p = probe_at<G>(lo, hi, lane);
    const int d = p >= 0 ? doc[p] : 0;
    narrow<G>(lo, hi,
              __popc(__ballot_sync(mask, p >= 0 && d < target) & mask));
  }
  return lo;
}

// x clamped into [lo, hi]
__device__ __forceinline__ long long clamp_index(long long x, long long lo,
                                                 long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// engine/kernels._binary_search of one target: the fixed-count int32
// lower bound in [lo, hi), n_iters halvings, reads clamped into the
// column (every value as the plain version reads it: int32 docs, or
// positions as uint16 bits / int32)
template <int kKind>  // 0: int32 docs, 1: uint16 positions, 2: int32 positions
__device__ __forceinline__ int search_fixed(const void* col, long long n,
                                            int target, int lo, int hi,
                                            int iters) {
  for (int it = 0; it < iters; ++it) {
    const int mid = (int)((unsigned)lo + (unsigned)hi) >> 1;
    const long long i = clamp_index(mid, 0, n - 1);
    const int v = kKind == 1 ? (int)static_cast<const uint16_t*>(col)[i]
                             : static_cast<const int32_t*>(col)[i];
    const bool less = v < target;
    lo = less ? mid + 1 : lo;
    hi = less ? hi : mid;
  }
  return lo;
}

// The posting index of doc target in the run [lo, hi) by the group's
// G-ary lower bound, where the fixed-count search (search_fixed, n_iters
// halvings) has converged (the run within 2^n_iters - 1 ids, inside the
// column, its int32 midpoints without wraparound) and the bound lies in
// the run: the two agree there. Returns -1 elsewhere (a run past the
// count, or a doc above every id of the run, where the fixed-count search
// may step past hi): the caller replays search_fixed<0>. Every lane of
// the group calls it and gets the index.
template <int G = 32>
__device__ __forceinline__ int recover(const int32_t* doc, long long n_doc,
                                       int target, int lo, int hi,
                                       int n_iters, int lane,
                                       unsigned mask = 0xffffffffu) {
  const long long run = (long long)hi - lo;
  const long long max_run = n_iters >= 31 ? (1LL << 31) : (1LL << n_iters) - 1;
  if (lo < 0 || run < 0 || hi > n_doc || hi >= (1 << 30) || run > max_run)
    return -1;
  const long long r = warp_lower_bound<G>(doc, lo, hi, target, lane, mask);
  return r < hi ? (int)r : -1;
}

}  // namespace wiser_bound
