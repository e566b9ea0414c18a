// A warp's 32-ary lower bound over a sorted int32 column: each round the
// warp's lanes probe 31 pivots (or every id of a range of at most 32) and
// one ballot narrows the range, so a run of n ids takes about log32(n)
// dependent rounds where a binary search takes log2(n). Shared by the bs
// step's tile path (tile.cuh) and the semidense phrase route's recovery
// (phrase_route.cu).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wiser_bound {

// One round of a warp's 32-ary lower bound in [lo, hi): the probe this
// lane makes (-1: none). Above 32 ids, 31 pivots lo + n(i+1)/32 split the
// range; at most 32, each id is probed.
__device__ __forceinline__ long long probe_at(long long lo, long long hi,
                                              int l32) {
  const long long n = hi - lo;
  if (n <= 0) return -1;
  if (n <= 32) return l32 < n ? lo + l32 : -1;
  return l32 < 31 ? lo + ((n * (l32 + 1)) >> 5) : -1;
}

// narrow [lo, hi) given c, the number of this round's probes below target
__device__ __forceinline__ void narrow(long long& lo, long long& hi, int c) {
  const long long n = hi - lo;
  if (n <= 0) return;
  if (n <= 32) {
    lo += c;
    hi = lo;
    return;
  }
  const long long l0 = lo;
  if (c > 0) lo = l0 + ((n * c) >> 5) + 1;
  if (c < 31) hi = l0 + ((n * (c + 1)) >> 5);
}

// The lower bound of target in the sorted ids [lo, hi) of the column, by
// one warp (uniform result). Reads only inside [lo, hi).
__device__ __forceinline__ long long warp_lower_bound(const int32_t* doc,
                                                      long long lo,
                                                      long long hi,
                                                      long long target,
                                                      int l32) {
  while (hi > lo) {
    const long long p = probe_at(lo, hi, l32);
    const int d = p >= 0 ? doc[p] : 0;
    narrow(lo, hi, __popc(__ballot_sync(0xffffffffu, p >= 0 && d < target)));
  }
  return lo;
}

}  // namespace wiser_bound
