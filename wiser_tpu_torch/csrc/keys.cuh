// Shared device code of the search kernels (search.cu, dense.cu): the tc
// score decode, the 64-bit selection keys and the shared-memory top-K
// machinery that sorts and merges them.
//
// A key orders (score desc, lane asc) as one unsigned integer: the f32
// score's bits mapped so that larger floats compare larger (-0 read as
// +0, which compares equal to it), above the inverted lane, above a bit
// that says the score was -0 (so the score comes back bit for bit). Keys
// of distinct lanes are unique, so a top K of keys is lax.top_k's tie
// order (equal scores by ascending lane) on every row. Key 0 lies below
// every key and pads a list.
//
// Every f32 operation is an explicit round-to-nearest intrinsic; the
// libraries that include this are built with -fmad=false besides.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace wiser_keys {

constexpr int kFlagTrunc = 1;
constexpr int kFlagTfSat = 4;
constexpr int kTfSat = 255;
// BM25 constants of the tc decode, as f32 values
constexpr float kK1 = 1.2f;
constexpr float kK1Plus1 = 2.2f;
constexpr float kB = 0.75f;
constexpr float kOneMinusB = 0.25f;

// kernels._char4_length: the 1-byte lossy length code's decoded length
// (3 mantissa bits, shift = code >> 3 - 1, capped at 27)
__device__ __forceinline__ int char4_length(int code) {
  const int bits = code & 7;
  const int shift = min((code >> 3) - 1, 27);
  return shift < 0 ? bits : (bits | 8) << max(shift, 0);
}

// kernels.tc_score in its operation order, in two parts: the length
// term of a len code (the same for every slot of a doc) and the score of
// a tf byte given it
__device__ __forceinline__ float tc_cache(int code, float avg) {
  const int length = char4_length(code);
  return __fmul_rn(
      kK1, __fadd_rn(kOneMinusB,
                     __fdiv_rn(__fmul_rn(kB, __int2float_rn(length)), avg)));
}

// the tf part of a lane's score before the multiply by idf
__device__ __forceinline__ float tc_norm(int tf_i, float cache) {
  const float tf = __int2float_rn(tf_i);
  float norm = __fdiv_rn(__fmul_rn(tf, kK1Plus1), __fadd_rn(tf, cache));
  if (tf_i >= kTfSat) norm = kK1Plus1;
  return norm;
}

__device__ __forceinline__ float tc_score_cached(int tf_i, float cache,
                                                 float idf) {
  return __fmul_rn(idf, tc_norm(tf_i, cache));
}

// The exact tc tables of one avg, filled by the G threads of a CTA
// (every thread calls it; it ends with a barrier): cache[code] =
// tc_cache(code, avg) for the 256 len codes, and norm[tf * 256 + code] =
// tc_norm(tf, cache[code]) for tf < tft (tf-major, so the lanes of a
// warp, whose tfs repeat and whose codes vary, gather from spread
// banks), so idf * norm[tf * 256 + code] is tc_score_cached(tf,
// cache[code], idf) bit for bit: the same operations on the same f32
// inputs.
template <int G>
__device__ void tc_fill_tables(float* cache, float* norm, int tft, float avg,
                               int tid) {
  for (int c = tid; c < 256; c += G) cache[c] = tc_cache(c, avg);
  __syncthreads();
  for (int i = tid; i < 256 * tft; i += G)
    norm[i] = tc_norm(i >> 8, cache[i & 255]);
  __syncthreads();
}

// lane = code8 << 8 | tf8
__device__ __forceinline__ float tc_score(int lane, float idf, float avg) {
  return tc_score_cached(lane & 0xFF, tc_cache((lane >> 8) & 0xFF, avg),
                         idf);
}

// The key of score s at lane (0 <= lane < 2^31).
__device__ __forceinline__ unsigned long long tile_key(float s, int lane) {
  const unsigned bits = __float_as_uint(s);
  const unsigned nz = bits == 0x80000000u;
  unsigned u = nz ? 0u : bits;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) |
         ((unsigned)(0x7fffffff - lane) << 1) | nz;
}

__device__ __forceinline__ int tile_key_lane(unsigned long long key) {
  return 0x7fffffff - (int)(((unsigned)key) >> 1);
}

__device__ __forceinline__ float tile_key_score(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  unsigned bits = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  if (key & 1) bits = 0x80000000u;
  return __uint_as_float(bits);
}

// A worker of G threads: a warp (G = 32) or the whole CTA.
template <int G>
__device__ __forceinline__ void wsync() {
  if (G == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

template <int G>
__device__ __forceinline__ int wany(bool p) {
  if (G == 32) return __any_sync(0xffffffffu, p);
  return __syncthreads_or(p);
}

// Descending bitonic sort of keys[0, P), P a power of 2, by G threads.
template <int G>
__device__ void bitonic_sort(unsigned long long* keys, int P, int tid) {
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (P >> 1); p += G) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int l = i + j;
        const unsigned long long x = keys[i], y = keys[l];
        if ((i & k) == 0 ? x < y : x > y) {
          keys[i] = y;
          keys[l] = x;
        }
      }
      wsync<G>();
    }
  }
}

// Descending order of the unique keys[0, c), in place: by rank where a
// thread can hold each key (its place is the number of keys above it),
// else a bitonic sort of the padded power of 2 (keys holds it).
template <int G>
__device__ void sort_keys(unsigned long long* keys, int c, int tid) {
  if (c <= G) {
    const unsigned long long k = tid < c ? keys[tid] : 0ull;
    int r = 0;
    if (tid < c)
      for (int j = 0; j < c; ++j) r += keys[j] > k;
    wsync<G>();
    if (tid < c) keys[r] = k;
    wsync<G>();
    return;
  }
  int P = 1;
  while (P < c) P <<= 1;
  for (int i = c + tid; i < P; i += G) keys[i] = 0ull;
  wsync<G>();
  bitonic_sort<G>(keys, P, tid);
}

// Merge the n_in keys of the descending list Q (nonzero; sources Qsrc,
// or src_base + index where Qsrc is null) with the descending running
// list R of KP (key, source) pairs, the top KP of both into R2: a key's
// place is its index plus the number of keys of the other list above it
// (keys are unique, R's padding 0s lie below every key of Q). kSrc
// false: keys alone (a key that names its lane needs no source).
template <int G, bool kSrc = true>
__device__ void merge_ranks(const unsigned long long* R, const uint32_t* Rsrc,
                            unsigned long long* R2, uint32_t* R2src, int KP,
                            const unsigned long long* Q, const uint32_t* Qsrc,
                            int n_in, uint32_t src_base, int tid) {
  const int top = n_in > 0 ? 1 << (31 - __clz(n_in)) : 0;
  for (int i = tid; i < KP; i += G) {
    const unsigned long long r = R[i];
    int p = 0;
    for (int step = top; step > 0; step >>= 1)
      if (p + step <= n_in && Q[p + step - 1] > r) p += step;
    if (i + p < KP) {
      R2[i + p] = r;
      if (kSrc) R2src[i + p] = Rsrc[i];
    }
  }
  for (int j = tid; j < n_in; j += G) {
    const unsigned long long q = Q[j];
    int p = 0;
    for (int step = KP >> 1; step > 0; step >>= 1)
      if (R[p + step - 1] > q) p += step;
    p += R[p] > q;
    if (j + p < KP) {
      R2[j + p] = q;
      if (kSrc) R2src[j + p] = Qsrc ? Qsrc[j] : src_base + j;
    }
  }
  wsync<G>();
}

// The number of nonzero keys of the descending, 0-padded list Q[0, K).
__device__ __forceinline__ int list_length(const unsigned long long* Q,
                                           int K) {
  int n = 0;
  for (int step = 1 << (31 - __clz(K)); step > 0; step >>= 1)
    if (n + step <= K && Q[n + step - 1] != 0ull) n += step;
  return n;
}

}  // namespace wiser_keys
