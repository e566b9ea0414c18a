// The position verification of one (query, lane) by one warp: the body of
// phrase.cu's verify_kernel, shared with phrase_route.cu's semidense
// phrase finish. phrase.cu's comment says what it computes and why.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wiser_verify {

// a warp's shared ints: T windows of PW positions, then T valid counts
__host__ __device__ constexpr long long warp_ints(int T, int PW) {
  return (long long)T * PW + T;
}

// position i of a column of uint16 (int16 bits) or int32 values
template <bool kU16>
__device__ __forceinline__ int position(const void* positions, long long i) {
  if (kU16) return static_cast<const uint16_t*>(positions)[i];
  return static_cast<const int32_t*>(positions)[i];
}

// The number of bases y (the anchor term's first PP valid positions
// minus the anchor) at which every term t holds y + t among its valid
// window entries. Thread t < T passes term t's bag bounds [s, e) (the
// others' are not read); each window starts at s clamped to [0, n - PW]
// and holds min(e - s, PW) entries, each read clamped into the column.
// win: the warp's warp_ints(T, PW) shared ints, one item a warp (a
// second item would need a __syncwarp before it refills them). Every
// thread of the warp calls it and gets the count.
template <bool kU16>
__device__ __forceinline__ int warp_count(const void* positions, long long n, long long s,
                          long long e, int T, int PP, int PW, int anchor,
                          int* win, int l32) {
  int* cnts = win + T * PW;
  long long start = 0;
  int cnt = 0;
  if (l32 < T) {
    const long long span = e - s;
    const long long top = n - PW;
    start = s < 0 ? 0 : (s > (top > 0 ? top : 0) ? (top > 0 ? top : 0) : s);
    cnt = (int)(span < 0 ? 0 : (span > PW ? PW : span));
    cnts[l32] = cnt;
  }
  for (int t = 0; t < T; ++t) {
    const long long st = __shfl_sync(0xffffffffu, start, t);
    const int c = __shfl_sync(0xffffffffu, cnt, t);
    for (int j = l32; j < c; j += 32) {
      const long long i = st + j;
      win[t * PW + j] = position<kU16>(positions, i < n ? i : n - 1);
    }
  }
  __syncwarp();
  const int A = anchor < 0 ? 0 : (anchor >= T ? T - 1 : anchor);
  const int nbase = min(cnts[A], PP);
  int count = 0;
  for (int i = l32; i < nbase; i += 32) {
    const int y = win[A * PW + i] - A;
    bool ok = true;
    for (int t = 0; t < T && ok; ++t) {
      if (t == A) continue;
      const int* w = win + t * PW;
      const int c = cnts[t], target = y + t;
      bool hit = false;
      for (int j = 0; j < c && !hit; ++j) hit = w[j] == target;
      ok = hit;
    }
    count += ok;
  }
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, off);
  return count;
}

}  // namespace wiser_verify
