// The selection machinery of a top K of 64-bit keys (keys.cuh) kept in an
// unsorted shared-memory buffer, shared by dense.cu (the full-scan mega
// phrase's selection, and the dense scan's flush) and segsel.cuh (the
// semidense step's and the semidense phrase route's segmented selection):
// keys above a threshold pushed into
// the buffer, the buffer cut to its top K by a radix select and a
// compaction when it fills (keep_top, which raises the threshold to the
// K-th key), and the kept keys sorted once at the end (sort_kept). Every
// function is called by all kSelThreads threads of a CTA.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "keys.cuh"

namespace wiser_select {

using namespace wiser_keys;

constexpr int kSelThreads = 256;  // the CTA of every caller
constexpr int kSelLPT = 4;        // keys a thread pushes at once

// This thread's LPT keys: those above tau go to X after the `base` keys
// already there, at places counted on *count (one atomic a warp and lane
// slot). Every thread of the CTA calls it.
__device__ __forceinline__ void push_keys(const unsigned long long* key,
                                          unsigned long long tau,
                                          unsigned long long* X, int base,
                                          int* count) {
  const unsigned lt = (1u << (threadIdx.x & 31)) - 1;
#pragma unroll
  for (int j = 0; j < kSelLPT; ++j) {
    const bool pass = key[j] > tau;
    const unsigned m = __ballot_sync(0xffffffffu, pass);
    if (m) {
      int at = 0;
      if ((threadIdx.x & 31) == __ffs(m) - 1) at = atomicAdd(count, __popc(m));
      at = __shfl_sync(0xffffffffu, at, __ffs(m) - 1);
      if (pass) X[base + at + __popc(m & lt)] = key[j];
    }
  }
}

// A flush's shared scratch: a digit histogram and the select's words;
// the selection's push threshold (tau: the keys above it are pushed).
struct FlushSmem {
  unsigned hist[256];
  unsigned digit, rem, count, n;
  unsigned long long key, tau;
};

// The k-th largest (1 <= k <= c) of the c unique keys X[0, c), by the CTA:
// a radix select from the top byte, each pass counting the keys with the
// prefix found so far (the digit most of a warp's lanes share added
// once), until one key alone has the prefix.
__device__ unsigned long long kth_key(const unsigned long long* X, int c,
                                      int k, FlushSmem& f, int tid) {
  const int wl = tid & 31;
  unsigned long long prefix = 0;
  unsigned rem = k;
  int shift = 56;
  for (;; shift -= 8) {
    for (int i = tid; i < 256; i += kSelThreads) f.hist[i] = 0;
    __syncthreads();
    const unsigned long long hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
    for (int i0 = 0; i0 < c; i0 += kSelThreads) {
      const int i = i0 + tid;
      const unsigned long long x = i < c ? X[i] : 0ull;
      const bool in = i < c && (x & hi) == prefix;
      const unsigned d = (unsigned)(x >> shift) & 255u;
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (act) {
        const int lead = __ffs(act) - 1;
        const unsigned dl = __shfl_sync(0xffffffffu, d, lead);
        const unsigned same = __ballot_sync(0xffffffffu, in && d == dl);
        if (wl == lead) atomicAdd(&f.hist[dl], __popc(same));
        if (in && d != dl) atomicAdd(&f.hist[d], 1u);
      }
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l
      unsigned sum = 0;
      for (int i = 0; i < 8; ++i) sum += f.hist[255 - 8 * tid - i];
      unsigned incl = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += y;
      }
      const unsigned q = __ballot_sync(0xffffffffu, incl >= rem);
      if (tid == __ffs(q) - 1) {
        unsigned cum = incl - sum;
        for (int i = 0; i < 8; ++i) {
          const int d = 255 - 8 * tid - i;
          if (cum + f.hist[d] >= rem) {
            f.digit = d;
            f.rem = rem - cum;
            f.count = f.hist[d];
            break;
          }
          cum += f.hist[d];
        }
      }
    }
    __syncthreads();
    prefix |= (unsigned long long)f.digit << shift;
    rem = f.rem;
    if (f.count == 1 || shift == 0) break;
  }
  if (shift == 0) return prefix;
  // the one key with this prefix
  for (int i = tid; i < c; i += kSelThreads)
    if ((X[i] >> shift) == (prefix >> shift)) f.key = X[i];
  __syncthreads();
  return f.key;
}

// The selection's flush: of the c > K unique keys X[0, c) keep the K
// largest, compacted in place to X[0, K) (unsorted): their least found by
// kth_key, the rest gathered a chunk of kSelThreads at a time (each chunk
// read before any of its places is written; a chunk's writes land below
// its end). Returns that least key. Every thread calls it; it ends with
// a barrier.
__device__ unsigned long long keep_top(unsigned long long* X, int c, int K,
                                       FlushSmem& f, int tid) {
  const unsigned long long t = kth_key(X, c, K, f, tid);
  if (tid == 0) f.n = 0;
  const unsigned lt = (1u << (tid & 31)) - 1;
  for (int i0 = 0; i0 < c; i0 += kSelThreads) {
    const int i = i0 + tid;
    const unsigned long long x = i < c ? X[i] : 0ull;
    __syncthreads();
    const bool keep = i < c && x >= t;
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (m) {
      int at = 0;
      if ((tid & 31) == __ffs(m) - 1) at = atomicAdd(&f.n, __popc(m));
      at = __shfl_sync(0xffffffffu, at, __ffs(m) - 1);
      if (keep) X[at + __popc(m & lt)] = x;
    }
  }
  __syncthreads();
  return t;
}

// The selection's c kept keys X[0, c) (c <= K, unsorted) in descending
// order, 0-padded to K. Every thread calls it; it ends with a barrier.
__device__ void sort_kept(unsigned long long* X, int c, int K, int tid) {
  sort_keys<kSelThreads>(X, c, tid);
  for (int i = c + tid; i < K; i += kSelThreads) X[i] = 0ull;
  __syncthreads();
}

}  // namespace wiser_select
