// The position verification of one (query, lane) by a group of G threads
// (a warp by default): the body of phrase.cu's group_kernel, shared with
// phrase_route.cu's semidense phrase finish. phrase.cu's comment says what
// it computes and why.

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
// window entries. Thread t < T of the group passes term t's bag bounds
// [s, e) (the others' are not read); each window starts at s clamped to
// [0, n - PW] and holds min(e - s, PW) entries, each read clamped into the
// column. win: the group's warp_ints(T, PW) shared ints, one item a group
// (a second item would need a __syncwarp before it refills them); lane:
// this thread's lane in the group, mask: the group's lanes. Every thread
// of the group calls it and gets the count.
template <bool kU16, int G = 32>
__device__ __forceinline__ int warp_count(const void* positions, long long n, long long s,
                          long long e, int T, int PP, int PW, int anchor,
                          int* win, int lane, unsigned mask = 0xffffffffu) {
  // a warp's shuffles keep their default width (warpSize), as its code
  // did before groups of 8 shared it
  const int width = G == 32 ? warpSize : G;
  int* cnts = win + T * PW;
  long long start = 0;
  int cnt = 0;
  if (lane < T) {
    const long long span = e - s;
    const long long top = n - PW;
    start = s < 0 ? 0 : (s > (top > 0 ? top : 0) ? (top > 0 ? top : 0) : s);
    cnt = (int)(span < 0 ? 0 : (span > PW ? PW : span));
    cnts[lane] = cnt;
  }
  for (int t = 0; t < T; ++t) {
    const long long st = __shfl_sync(mask, start, t, width);
    const int c = __shfl_sync(mask, cnt, t, width);
    for (int j = lane; j < c; j += G) {
      const long long i = st + j;
      win[t * PW + j] = position<kU16>(positions, i < n ? i : n - 1);
    }
  }
  __syncwarp(mask);
  const int A = anchor < 0 ? 0 : (anchor >= T ? T - 1 : anchor);
  const int nbase = min(cnts[A], PP);
  int count = 0;
  for (int i = lane; i < nbase; i += G) {
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
  for (int off = G / 2; off > 0; off >>= 1)
    count += __shfl_xor_sync(mask, count, off, width);
  return count;
}

}  // namespace wiser_verify
