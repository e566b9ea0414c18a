// The tile path and the plane path of the bs step (search.cu): the
// candidate stream, each searched slot's cursor window in shared memory,
// the running top K of 64-bit keys and the winners' outputs. search.cu's
// comment says what the paths do and why; this file is their code. The
// including file defines WISER_TILE_NS, the namespace the kernels are
// compiled into (so that a library's kernels carry its name in a trace).

#ifndef WISER_TILE_NS
#error "define WISER_TILE_NS before including tile.cuh"
#endif

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bound.cuh"
#include "keys.cuh"

// A wrapper's arguments (ops/search._Params, every field 8 bytes):
// pointers to device memory or 0, counts, and the plan.
struct WiserStepParams {
  long long doc, n_doc, score, n_score, tf, n_tf, tc, n_tc;
  long long starts, ends, weights, avg32;
  long long B, T, L, M, n_iters;
  long long path;  // 0: tiles, 1: plane
  long long G, LPT, ntiles, nseg, tps, K, KP, smem, merge_smem;
  long long lo_scratch, part_keys, part_src;
  long long plane, sort_scratch, P;
  long long top_docs, top_score, top_tfs, top_pidx, flags;
};

namespace WISER_TILE_NS {

using namespace wiser_bound;
using namespace wiser_keys;

constexpr int kThreads = 256;    // every launch's CTA
constexpr int kKeyCap = 1024;    // the tile path's largest K = min(M+1, L)
constexpr int kWarpWindow = 256; // window ids a chunk of a warp worker
constexpr int kMiscBytes = 512;  // a worker's scalars (struct Misc)
// CTAs an SM keeps of the tile kernel: the step waits on memory, so
// registers are capped at 65,536 / (256 * 4) = 64 a thread (no spills up
// to 4 lanes a thread; 3 and 2 CTAs ran 15-35% slower, 5 and 6 spilled)
constexpr int kMinBlocks = 4;

struct Args {
  const int32_t* doc;
  long long n_doc;
  const float* score;  // raw
  long long n_score;
  const int32_t* tf;  // raw
  long long n_tf;
  const uint16_t* tc;  // tc: uint16 lanes; null on raw columns
  long long n_tc;
  const int32_t* starts;  // (B, T)
  const int32_t* ends;    // (B, T)
  const float* weights;   // (B, T): use_score (raw) or idf32 (tc)
  const float* avg32;     // tc: one f32
  int B, T, L, M, n_iters;
  // tile path: tiles of TL lanes, nseg workers a query each taking tps
  // tiles, K = min(M + 1, L) keys kept, KP the power of 2 >= K
  int TL, ntiles, nseg, tps, K, KP;
  int32_t* lo_scratch;             // (B, T-1, ntiles * K) when ntiles > 1
  unsigned long long* part_keys;   // (B, nseg, K) when nseg > 1
  uint32_t* part_src;              // (B, nseg, K)
  // plane path
  float* plane;                       // (B, L)
  // the sort buffer: P (a power of 2 >= min(M + 1, L)) keys in dynamic
  // shared memory up to P = 4,096 (32 KB; ops/search.SMEM_KEYS), else
  // sort_scratch, (B, P) in device memory
  unsigned long long* sort_scratch;
  int P;
  int32_t* top_docs;   // (B, M)
  float* top_score;    // (B, M)
  int32_t* top_tfs;    // (B, T, M)
  int32_t* top_pidx;   // (B, T, M)
  int32_t* flags;      // (B,)
};

constexpr int kCursors = 8;  // slots 1..8 keep a cursor into their run

// A worker's scalars, at the start of its shared region.
struct Misc {
  long long wlo;              // the slot's window start (broadcast)
  long long cursor[kCursors]; // per slot: the lower bound of pmx + 1
  int pmx[kCursors];          // per slot: the last tile's largest live doc
  // per-warp partials of a CTA worker's live-lane stats, by slot parity
  int mn[2][8], mx[2][8], cnt[2][8];
  int count[2];               // the tiles' compacted keys, by parity
};
static_assert(sizeof(Misc) <= kMiscBytes, "Misc outgrew its bytes");

__host__ __device__ constexpr long long align8(long long x) {
  return (x + 7) & ~7LL;
}

__host__ __device__ constexpr long long window_ids(int G, int TL) {
  return G == 32 ? kWarpWindow : TL;
}

// One worker's shared bytes: Misc | S (the next tile's candidate docs, TL
// int32) | X (the tile's keys; the window chunks' three buffers) | R and
// R2 (each KP running keys, then KP u32 sources; several tiles only) | lo
// ((T-1, TL) int32, T the slots searched). ops/search.plan computes the
// same.
__host__ __device__ constexpr long long s_bytes(int TL) {
  return align8(TL * 4LL);
}

__host__ __device__ constexpr long long x_bytes(int G, int TL) {
  return (2 * TL > 3 * window_ids(G, TL) ? 2 * TL : 3 * window_ids(G, TL)) *
         4LL;
}

__host__ __device__ constexpr long long r_bytes(int KP, bool multi) {
  return multi ? 2 * align8(KP * 12LL) : 0;
}

__host__ __device__ constexpr long long worker_bytes(int G, int T, int TL,
                                                     int KP, bool multi) {
  return kMiscBytes + s_bytes(TL) + x_bytes(G, TL) + r_bytes(KP, multi) +
         align8((long long)(T - 1) * TL * 4);
}

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// the start of a contiguous L-lane load, clamped as dynamic_slice clamps it
__device__ __forceinline__ long long slice_start(long long s, long long n,
                                                 int L) {
  const long long top = n - L;
  return clampll(s, 0, top > 0 ? top : 0);
}

__device__ __forceinline__ int tc_lane(const Args& a, long long i) {
  return a.tc[clampll(i, 0, a.n_tc - 1)];
}

// the score of a tc lane (code8 << 8 | tf8) in a slot of this idf
__device__ __forceinline__ float lane_score(const Args& a, int lane,
                                            float idf, float avg) {
  return tc_score(lane, idf, avg);
}

// the first position in [lo, hi) whose doc is >= target, after at most
// n_iters halvings (the fixed-count loop's `found`, and its lo wherever
// found holds)
__device__ __forceinline__ long long lower_bound(const Args& a, int target,
                                                 long long lo, long long hi) {
  for (int it = 0; it < a.n_iters && lo < hi; ++it) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (a.doc[clampll(mid, 0, a.n_doc - 1)] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ bool found_at(const Args& a, long long lo,
                                         long long end, int target) {
  return lo < end && a.doc[clampll(lo, 0, a.n_doc - 1)] == target;
}

// ---------------------------------------------------------------------------
// The tile path.

// The live lanes' min, max and count over the worker: stats_put reduces
// them over the warp and, in a CTA worker, leaves each warp's partials in
// Misc by slot parity; stats_get, a barrier later, combines them (a warp
// worker's values are whole after the put).
template <int G>
__device__ __forceinline__ void stats_put(int& mn, int& mx, int& cnt,
                                          Misc* ms, int par, int tid) {
  for (int off = 16; off > 0; off >>= 1) {
    mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }
  if (G > 32 && (tid & 31) == 0) {
    ms->mn[par][tid >> 5] = mn;
    ms->mx[par][tid >> 5] = mx;
    ms->cnt[par][tid >> 5] = cnt;
  }
}

template <int G>
__device__ __forceinline__ void stats_get(int& mn, int& mx, int& cnt,
                                          const Misc* ms, int par) {
  if (G == 32) return;
  mn = ms->mn[par][0];
  mx = ms->mx[par][0];
  cnt = ms->cnt[par][0];
  for (int i = 1; i < G / 32; ++i) {
    mn = min(mn, ms->mn[par][i]);
    mx = max(mx, ms->mx[par][i]);
    cnt += ms->cnt[par][i];
  }
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The outputs of query b from its sorted keys (navail of them readable,
// padding 0 past the real ones): lower bounds from the one tile's s_lo
// (tile width TL) or, with sources, from lo_scratch.
template <int G>
__device__ void write_outputs(const Args& a, int b,
                              const unsigned long long* keys,
                              const uint32_t* src, int navail,
                              const int32_t* s_lo, int TL, int tid) {
  const int T = a.T, M = a.M;
  const int NS = T;  // the slots searched
  const long long cs = a.starts[(long long)b * T];
  const long long s_doc = slice_start(cs, a.n_doc, a.L);
  const float ninf = -__int_as_float(0x7f800000);
  bool sat = false;
  for (int m = tid; m < M; m += G) {
    const unsigned long long key = m < navail ? keys[m] : 0ull;
    const long long o = (long long)b * M + m;
    float s = ninf;
    int lane = 0;
    if (key) {
      lane = tile_key_lane(key);
      s = tile_key_score(key);
    }
    const bool kept = s > ninf;
    const int doc = kept ? a.doc[s_doc + lane] : -1;
    a.top_score[o] = s;
    a.top_docs[o] = doc;
    for (int t = 0; t < T; ++t) {
      const long long ot = ((long long)b * T + t) * M + m;
      long long pidx = -1;
      if (key) {
        if (t == 0) {
          pidx = cs + lane;
        } else if (s_lo) {
          pidx = s_lo[(t - 1) * TL + lane];
        } else {
          pidx = a.lo_scratch[((long long)b * (NS - 1) + (t - 1)) *
                                  ((long long)a.ntiles * a.K) +
                              src[m]];
        }
      }
      a.top_pidx[ot] = (int32_t)pidx;
      int tf = 0;
      if (kept) {
        if (a.tc) {
          tf = tc_lane(a, pidx) & 0xFF;
          sat = sat || tf >= kTfSat;
        } else {
          tf = a.tf[clampll(pidx, 0, a.n_tf - 1)];
        }
      }
      a.top_tfs[ot] = tf;
    }
  }
  const int any_sat = wany<G>(sat);
  if (tid == 0) {
    int f = 0;
    if (a.K > M) {
      const unsigned long long k0 = M - 1 < navail ? keys[M - 1] : 0ull;
      const unsigned long long k1 = M < navail ? keys[M] : 0ull;
      const float s0 = k0 ? tile_key_score(k0) : ninf;
      const float s1 = k1 ? tile_key_score(k1) : ninf;
      if (s0 > ninf && s1 == s0) f |= kFlagTrunc;
    }
    if (any_sat) f |= kFlagTfSat;
    a.flags[b] = f;
  }
}

// One (query, segment of tiles) per worker: G = 32 (a warp, 8 queries a
// CTA, L <= 128) or G = 256 (the CTA); TL = G * LPT lanes a tile.
template <int G, int LPT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tile_kernel(Args a) {
  constexpr int TL = G * LPT;
  constexpr int W = kThreads / G;
  static_assert(LPT <= 32, "lane masks are 32-bit");
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x % G;
  const int wid = threadIdx.x / G;
  const bool multi = a.ntiles > 1;
  unsigned char* base =
      smem + wid * worker_bytes(G, a.T, TL, a.KP, multi);
  Misc* ms = reinterpret_cast<Misc*>(base);
  int32_t* S = reinterpret_cast<int32_t*>(base + kMiscBytes);
  unsigned long long* X = reinterpret_cast<unsigned long long*>(
      base + kMiscBytes + s_bytes(TL));
  unsigned long long* R = reinterpret_cast<unsigned long long*>(
      base + kMiscBytes + s_bytes(TL) + x_bytes(G, TL));
  uint32_t* Rsrc = reinterpret_cast<uint32_t*>(R + a.KP);
  unsigned long long* R2 = reinterpret_cast<unsigned long long*>(
      reinterpret_cast<unsigned char*>(R) + align8(a.KP * 12LL));
  uint32_t* R2src = reinterpret_cast<uint32_t*>(R2 + a.KP);
  int32_t* s_lo = reinterpret_cast<int32_t*>(
      base + kMiscBytes + s_bytes(TL) + x_bytes(G, TL) +
      r_bytes(a.KP, multi));
  int b, seg;
  if (G == 32) {
    b = blockIdx.x * W + wid;
    seg = 0;
    if (b >= a.B) return;  // the warp alone: it syncs with no other
  } else {
    b = blockIdx.x / a.nseg;
    seg = blockIdx.x % a.nseg;
  }
  const int T = a.T;
  const int NS = T;  // the slots searched
  const int32_t* st = a.starts + (long long)b * T;
  const int32_t* en = a.ends + (long long)b * T;
  const float* w = a.weights + (long long)b * T;
  const long long cs = st[0];
  const long long n_valid = clampll((long long)en[0] - cs, 0, a.L);
  const long long s_doc = slice_start(cs, a.n_doc, a.L);
  const long long s_col = slice_start(cs, a.tc ? a.n_tc : a.n_score, a.L);
  const float avg = a.tc ? *a.avg32 : 0.f;
  const float ninf = -__int_as_float(0x7f800000);
  // the longest run the bounded search always finishes
  const long long max_run =
      a.n_iters >= 62 ? LLONG_MAX : (1LL << a.n_iters) - 1;
  constexpr long long kWin = window_ids(G, TL);
  int32_t* const bufs = reinterpret_cast<int32_t*>(X);  // 3 x kWin ids

  if (multi) {
    for (int i = tid; i < a.KP; i += G) {
      R[i] = 0ull;
      Rsrc[i] = 0u;
    }
  }
  if (tid == 0)
    for (int i = 0; i < kCursors; ++i) ms->pmx[i] = INT_MAX;  // none yet
  // a thread copies the candidate docs of its own lanes of a tile into S
  // (so it reads them back without a barrier), a tile ahead
  const int t_first = seg * a.tps;
  const int t_end = min(a.ntiles, (seg + 1) * a.tps);
  auto stage = [&](int tile) {
    const long long tile0 = (long long)tile * TL;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const long long lane = tile0 + j * G + tid;
      if (tile < t_end && lane < n_valid)
        cp_async4(S + j * G + tid, a.doc + s_doc + lane);
    }
    cp_async_commit();
  };
  stage(t_first);
  if (tid == 0) ms->count[t_first & 1] = 0;
  wsync<G>();
  int n_sorted = 0;  // one tile: the sorted keys in X
  for (int tile = t_first; tile < t_end; ++tile) {
    const long long tile0 = (long long)tile * TL;
    if (tile0 >= n_valid) break;
    int d[LPT];
    float cv[LPT], acc[LPT];
    unsigned alive = 0;
    cp_async_wait<0>();
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      const long long lane = tile0 + j * G + tid;
      d[j] = 0;
      cv[j] = 0.f;
      acc[j] = 0.f;
      if (lane < n_valid) {
        alive |= 1u << j;
        d[j] = S[j * G + tid];
        cv[j] = a.tc ? lane_score(a, a.tc[s_col + lane], w[0], avg)
                     : a.score[s_col + lane];
      }
    }
    stage(tile + 1);
    int pv[LPT];         // a found lane's payload: score bits (raw), tc lane
    unsigned found = 0;  // the slot's found lanes, their payloads loading
    int t = 1;
    // lane slot j holds the doc at lo: its lower bound kept for the
    // winners, its payload (clamped as _gather1d) loaded
    auto hit = [&](int j, long long lo) {
      found |= 1u << j;
      s_lo[(t - 1) * TL + j * G + tid] = (int32_t)lo;
      pv[j] = a.tc ? tc_lane(a, lo)
                   : __float_as_int(a.score[clampll(lo, 0, a.n_score - 1)]);
    };
    // slot tp's partial scores added in slot order; called a barrier
    // after the slot, so the payload loads have landed meanwhile
    auto add = [&](int tp) {
      const float wt = w[tp];
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (found >> j & 1) {
          const float p = a.tc ? lane_score(a, pv[j], wt, avg)
                               : __fmul_rn(__int_as_float(pv[j]), wt);
          acc[j] = tp == 1 ? p : __fadd_rn(acc[j], p);
        }
      }
    };
    // a window chunk of the run ending at e: kWin ids from `from` into
    // dst, a chunk shorter than kWin padded with INT_MAX (above every
    // doc the lanes search for)
    auto load = [&](int32_t* dst, long long from, long long e) {
      const long long n = min(kWin, e - from);
      for (int i = tid; i < kWin; i += G) {
        if (i < n) {
          cp_async4(dst + i, a.doc + from + i);
        } else {
          dst[i] = INT_MAX;
        }
      }
      cp_async_commit();
    };
    // the live lanes' stats of the slot with parity par
    int mn, mx, live;
    auto put = [&](int par) {
      mn = INT_MAX;
      mx = INT_MIN;
      live = 0;
#pragma unroll
      for (int j = 0; j < LPT; ++j) {
        if (alive >> j & 1) {
          mn = min(mn, d[j]);
          mx = max(mx, d[j]);
          ++live;
        }
      }
      stats_put<G>(mn, mx, live, ms, par, tid);
    };
    if (NS > 1) {
      put(1);
      wsync<G>();
    }
    for (; t < NS; ++t) {
      const long long s_t = st[t], e_t = en[t];
      const bool exact =
          s_t >= 0 && e_t <= a.n_doc && e_t - s_t <= max_run;
      // with a cursor into this slot's run (the last tile's window end),
      // the first chunk goes out before the barrier below; the cursor is
      // read once here, and rewritten only after the slot's last barrier
      const int pm = t <= kCursors ? ms->pmx[t - 1] : INT_MAX;
      const bool have_cur = exact && pm != INT_MAX;
      const long long cur0 = have_cur ? ms->cursor[t - 1] : 0;
      bool new_cur = false;
      long long cur = e_t;  // tid 0: the new cursor
      const bool early = have_cur && cur0 < e_t;
      if (early) load(bufs, cur0, e_t);
      stats_get<G>(mn, mx, live, ms, t & 1);
      if (t > 1) add(t - 1);
      found = 0;
      if (live == 0) {
        cp_async_wait<0>();
        break;
      }
      if (!exact) {
        // the bounded search may stop short of the lower bound: the
        // fixed-count loop per lane, as the first form ran it
#pragma unroll
        for (int j = 0; j < LPT; ++j) {
          if (alive >> j & 1) {
            const long long l = lower_bound(a, d[j], s_t, e_t);
            if (found_at(a, l, e_t, d[j])) hit(j, l);
          }
        }
      } else if (e_t > s_t) {
        // The window starts at the lower bound of mn: the slot's cursor
        // where this tile's live docs all pass the last tile's (sorted
        // tiles: the run streams on with no search), else a warp's search.
        const bool cursor = have_cur && mn > pm;
        if (!cursor) {
          cp_async_wait<0>();  // the first buffer is loaded again
          if (tid < 32) {
            const long long r = warp_lower_bound(a.doc, s_t, e_t, mn, tid);
            if (tid == 0) ms->wlo = r;
          }
          wsync<G>();
        }
        const long long wlo = cursor ? cur0 : ms->wlo;
        // stream the run from wlo through shared memory, a chunk ahead,
        // until a chunk ends past mx; past `budget` ids (what the live
        // lanes' searches would move: a 32-byte sector, 8 ids, a probe)
        // the rest is searched per lane
        const long long rest = e_t - wlo;
        const long long budget =
            8LL * live * (rest > 0 ? 64 - __clzll(rest) : 0);
        unsigned pending = alive;
        long long nxt = wlo;  // the next chunk's start
        int stop = rest > 0 ? 0 : 1;
        new_cur = t <= kCursors;
        if (rest > 0 && !cursor) load(bufs, wlo, e_t);
        // three buffers: the one a chunk reads ahead into was last read
        // two chunks back, before the barrier of the chunk between
        for (int ci = 0; !stop; ++ci) {
          const long long c0 = nxt;
          const int len = (int)min(kWin, e_t - c0);
          nxt = c0 + len;
          const bool ahead = nxt < e_t && nxt - wlo < budget;
          if (ahead) {
            load(bufs + ((ci + 1) % 3) * kWin, nxt, e_t);
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          wsync<G>();
          const int32_t* buf = bufs + (ci % 3) * kWin;
          const int last = buf[len - 1];
          // the lanes whose lower bound lies in this chunk find it by
          // binary lifting over the whole padded chunk (a fixed, unrolled
          // depth), a lane slot at a time where any lane of the warp
          // needs it; a found lane's payload load goes out here
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            const bool mine = (pending >> j & 1) && d[j] <= last;
            if (__any_sync(0xffffffffu, mine)) {
              int p = 0;
#pragma unroll
              for (int step = (int)kWin >> 1; step > 0; step >>= 1)
                if (buf[p + step - 1] < d[j]) p += step;
              if (mine) {
                pending &= ~(1u << j);
                if (buf[p] == d[j]) hit(j, c0 + p);
              }
            }
          }
          if (last > mx) {
            stop = 1;
            if (tid == 0) {  // the cursor: the lower bound of mx + 1
              int p = 0;
              for (int step = 1 << (31 - __clz(len)); step > 0; step >>= 1)
                if (p + step <= len && buf[p + step - 1] <= mx) p += step;
              cur = c0 + p;
            }
          } else if (!ahead && nxt < e_t) {
            stop = 2;
          } else if (nxt >= e_t) {
            stop = 1;
          }
        }
        cp_async_wait<0>();  // a chunk read ahead may still land
        if (stop == 2) {
          // the budget ran out: the live lanes still pending search the
          // rest of the run alone, and a warp finds the cursor
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            if (pending >> j & 1) {
              long long l = nxt, h = e_t;
              while (l < h) {
                const long long mid = l + ((h - l) >> 1);
                if (a.doc[mid] < d[j]) {
                  l = mid + 1;
                } else {
                  h = mid;
                }
              }
              if (l < e_t && a.doc[l] == d[j]) hit(j, l);
            }
          }
          if (tid < 32)
            cur = warp_lower_bound(a.doc, nxt, e_t, (long long)mx + 1, tid);
        }
      }
      alive = found;
      if (t + 1 < NS) put((t + 1) & 1);
      wsync<G>();  // Misc and the window buffers are free again
      if (tid == 0 && new_cur) {
        ms->cursor[t - 1] = cur;
        ms->pmx[t - 1] = mx;
      }
    }
    if (found) add(t - 1);  // the last slot (a break left found 0)

    // the tile's matched keys above the running threshold, compacted
    // keys at or below the running K-th cannot enter the top K; the
    // count of this tile's parity was zeroed a tile back
    const unsigned long long tau = multi ? R[a.K - 1] : 0ull;
    int* count = &ms->count[tile & 1];
    // one shared atomic a warp and lane slot: the passing lanes' ranks
    // in the warp's ballot give their places
    const unsigned lt = (1u << (threadIdx.x & 31)) - 1;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      unsigned long long key = 0ull;
      bool pass = false;
      if (alive >> j & 1) {
        const float s =
            T == 1 ? cv[j]
                   : (a.tc ? __fadd_rn(cv[j], acc[j])
                           : __fadd_rn(__fmul_rn(cv[j], w[0]), acc[j]));
        key = tile_key(s, (int)(tile0 + j * G + tid));
        pass = s != ninf && key > tau;
      }
      const unsigned m = __ballot_sync(0xffffffffu, pass);
      if (m) {
        int at = 0;
        if ((threadIdx.x & 31) == __ffs(m) - 1)
          at = atomicAdd(count, __popc(m));
        at = __shfl_sync(0xffffffffu, at, __ffs(m) - 1);
        if (pass) X[at + __popc(m & lt)] = key;
      }
    }
    wsync<G>();
    const int c = *count;
    // every thread is past the last tile: zero the next tile's count
    // (a barrier of this tile, or below, comes before its adds)
    if (tid == 0) ms->count[(tile + 1) & 1] = 0;
    if (c == 0) {
      if (NS == 1) wsync<G>();
      continue;
    }
    sort_keys<G>(X, c, tid);
    if (!multi) {
      n_sorted = c;
      break;
    }
    // the tile's top K: their lower bounds out, their keys merged in
    const int n_in = min(c, a.K);
    const uint32_t src_base = (uint32_t)tile * a.K;
    for (int i = tid; i < n_in * (NS - 1); i += G) {
      const int j = i % n_in, t = i / n_in;
      const int lane = tile_key_lane(X[j]) - (int)tile0;
      a.lo_scratch[((long long)b * (NS - 1) + t) *
                       ((long long)a.ntiles * a.K) +
                   src_base + j] = s_lo[t * TL + lane];
    }
    merge_ranks<G>(R, Rsrc, R2, R2src, a.KP, X, nullptr, n_in, src_base,
                   tid);
    unsigned long long* rk = R;
    R = R2;
    R2 = rk;
    uint32_t* rs = Rsrc;
    Rsrc = R2src;
    R2src = rs;
  }

  if (!multi) {
    write_outputs<G>(a, b, X, nullptr, n_sorted, s_lo, TL, tid);
  } else if (a.nseg == 1) {
    write_outputs<G>(a, b, R, Rsrc, a.KP, nullptr, TL, tid);
  } else {
    const long long o = ((long long)b * a.nseg + seg) * a.K;
    for (int i = tid; i < a.K; i += G) {
      a.part_keys[o + i] = R[i];
      a.part_src[o + i] = Rsrc[i];
    }
  }
}

// The second launch where a query's tiles span nseg workers: one CTA a
// query merges their nseg lists of K pairs and writes the outputs.
__global__ void __launch_bounds__(kThreads) merge_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = a.KP, K = a.K;
  const long long rb = align8(KP * 12LL);
  unsigned long long* R =
      reinterpret_cast<unsigned long long*>(smem + kMiscBytes);
  unsigned long long* R2 =
      reinterpret_cast<unsigned long long*>(smem + kMiscBytes + rb);
  unsigned long long* Q =
      reinterpret_cast<unsigned long long*>(smem + kMiscBytes + 2 * rb);
  uint32_t* Rsrc = reinterpret_cast<uint32_t*>(R + KP);
  uint32_t* R2src = reinterpret_cast<uint32_t*>(R2 + KP);
  uint32_t* Qsrc = reinterpret_cast<uint32_t*>(Q + KP);
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long o = (long long)b * a.nseg * K;
  for (int i = tid; i < KP; i += kThreads) {
    R[i] = i < K ? a.part_keys[o + i] : 0ull;
    Rsrc[i] = i < K ? a.part_src[o + i] : 0u;
  }
  for (int s = 1; s < a.nseg; ++s) {
    for (int i = tid; i < K; i += kThreads) {
      Q[i] = a.part_keys[o + (long long)s * K + i];
      Qsrc[i] = a.part_src[o + (long long)s * K + i];
    }
    __syncthreads();
    const int n_in = list_length(Q, K);  // its 0s pad it
    merge_ranks<kThreads>(R, Rsrc, R2, R2src, KP, Q, Qsrc, n_in, 0u, tid);
    unsigned long long* rk = R;
    R = R2;
    R2 = rk;
    uint32_t* rs = Rsrc;
    Rsrc = R2src;
    R2src = rs;
  }
  __syncthreads();
  write_outputs<kThreads>(a, b, R, Rsrc, KP, nullptr, 0, tid);
}

// ---------------------------------------------------------------------------
// The plane path (M + 1 > kKeyCap): the first form's two launches.

// Launch 1: the score plane, one thread per (lane, query).
__global__ void __launch_bounds__(kThreads) score_kernel(Args a) {
  const int b = blockIdx.y;
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= a.L) return;
  const int32_t* st = a.starts + (long long)b * a.T;
  const int32_t* en = a.ends + (long long)b * a.T;
  const float* w = a.weights + (long long)b * a.T;
  const long long cs = st[0];
  float score = -__int_as_float(0x7f800000);
  if ((long long)lane < (long long)en[0] - cs) {
    const int target = a.doc[slice_start(cs, a.n_doc, a.L) + lane];
    const float avg = a.tc ? *a.avg32 : 0.f;
    const int ctc =
        a.tc ? tc_lane(a, slice_start(cs, a.n_tc, a.L) + lane) : 0;
    const float cscore = a.tc
                             ? lane_score(a, ctc, w[0], avg)
                             : a.score[slice_start(cs, a.n_score, a.L) + lane];
    const int NS = a.T;  // the slots searched
    if (a.T == 1) {
      score = cscore;
    } else {
      float acc = 0.f;
      bool match = true;
      for (int t = 1; t < NS; ++t) {
        const long long end = en[t];
        const long long lo = lower_bound(a, target, st[t], end);
        if (!found_at(a, lo, end, target)) {
          match = false;
          break;
        }
        const float p =
            a.tc ? lane_score(a, tc_lane(a, lo), w[t], avg)
                 : __fmul_rn(a.score[clampll(lo, 0, a.n_score - 1)], w[t]);
        acc = t == 1 ? p : __fadd_rn(acc, p);
      }
      if (match) {
        score = a.tc ? __fadd_rn(cscore, acc)
                     : __fadd_rn(__fmul_rn(cscore, w[0]), acc);
      }
    }
  }
  a.plane[(long long)b * a.L + lane] = score;
}

// (score desc, lane asc) as one unsigned order: the score's bits mapped so
// that larger floats compare larger (-0 read as +0, which compares equal to
// it), above the inverted lane
__device__ __forceinline__ unsigned long long make_key(float s, int lane) {
  unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned)(~lane);
}

__device__ __forceinline__ int key_lane(unsigned long long key) {
  return (int)(~(unsigned)key);
}

// Launch 2: the top-M selection and the winners, one CTA per query.
__global__ void __launch_bounds__(kThreads) select_kernel(Args a) {
  extern __shared__ unsigned long long smem_keys[];
  __shared__ unsigned hist[256];
  __shared__ unsigned long long s_prefix;
  __shared__ unsigned s_rem, s_cnt;
  __shared__ int s_done, s_sat;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const float* sc = a.plane + (long long)b * a.L;
  const int K = min(a.M + 1, a.L);  // keys to keep: M and the flag's next
  unsigned long long* buf =
      a.sort_scratch ? a.sort_scratch + (long long)b * a.P : smem_keys;

  // radix select: the keys whose top (64 - shift) bits are >= prefix's
  // number exactly K; shift 64 keeps every lane
  int shift = 64;
  unsigned long long prefix = 0;
  if (K < a.L) {
    unsigned rem = K;
    for (shift = 56;; shift -= 8) {
      for (int i = tid; i < 256; i += nt) hist[i] = 0;
      __syncthreads();
      for (int l = tid; l < a.L; l += nt) {
        const unsigned long long key = make_key(sc[l], l);
        if (shift == 56 || (key >> (shift + 8)) == (prefix >> (shift + 8)))
          atomicAdd(&hist[(key >> shift) & 255], 1u);
      }
      __syncthreads();
      if (tid == 0) {
        unsigned cum = 0;
        int d = 255;
        for (; d > 0; --d) {
          if (cum + hist[d] >= rem) break;
          cum += hist[d];
        }
        s_rem = rem - cum;
        s_prefix = prefix | ((unsigned long long)d << shift);
        s_done = hist[d] == rem - cum;  // the digit's bucket is taken whole
      }
      __syncthreads();
      rem = s_rem;
      prefix = s_prefix;
      const bool done = s_done;
      __syncthreads();
      if (done || shift == 0) break;
    }
  }

  if (tid == 0) {
    s_cnt = 0;
    s_sat = 0;
  }
  __syncthreads();
  for (int l = tid; l < a.L; l += nt) {
    const unsigned long long key = make_key(sc[l], l);
    if (shift == 64 || (key >> shift) >= (prefix >> shift))
      buf[atomicAdd(&s_cnt, 1u)] = key;
  }
  for (int i = K + tid; i < a.P; i += nt) buf[i] = 0;  // below every key
  __syncthreads();

  // bitonic sort, descending
  for (int k = 2; k <= a.P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < a.P; i += nt) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long x = buf[i], y = buf[ixj];
          if ((i & k) == 0 ? x < y : x > y) {
            buf[i] = y;
            buf[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  // the winners
  const int32_t* st = a.starts + (long long)b * a.T;
  const int32_t* en = a.ends + (long long)b * a.T;
  const long long cs = st[0];
  const long long n_valid = (long long)en[0] - cs;
  const long long s_doc = slice_start(cs, a.n_doc, a.L);
  for (int m = tid; m < a.M; m += nt) {
    const int lane = key_lane(buf[m]);
    const float s = sc[lane];
    const bool kept = s > -__int_as_float(0x7f800000);
    const int target = lane < n_valid ? a.doc[s_doc + lane] : INT_MAX;
    const long long o = (long long)b * a.M + m;
    a.top_score[o] = s;
    a.top_docs[o] = kept ? target : -1;
    bool sat = false;
    for (int t = 0; t < a.T; ++t) {
      const long long ot = ((long long)b * a.T + t) * a.M + m;
      const long long pidx =
          t == 0 ? cs + lane : lower_bound(a, target, st[t], en[t]);
      a.top_pidx[ot] = (int32_t)pidx;
      int tf = 0;
      if (kept) {
        if (a.tc) {
          tf = tc_lane(a, pidx) & 0xFF;
          sat = sat || tf >= kTfSat;
        } else {
          tf = a.tf[clampll(pidx, 0, a.n_tf - 1)];
        }
      }
      a.top_tfs[ot] = tf;
    }
    if (sat) s_sat = 1;
  }
  __syncthreads();
  if (tid == 0) {
    int f = 0;
    if (K > a.M) {
      const float sm = sc[key_lane(buf[a.M - 1])];
      if (sm > -__int_as_float(0x7f800000) && sc[key_lane(buf[a.M])] == sm)
        f |= kFlagTrunc;
    }
    if (s_sat) f |= kFlagTfSat;
    a.flags[b] = f;
  }
}

template <int G, int LPT>
cudaError_t launch_tile(const Args& a, unsigned grid, size_t smem,
                        cudaStream_t s) {
  if (smem > (48u << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_kernel<G, LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  tile_kernel<G, LPT><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}


// Launch the step on `stream` (no synchronize). Returns the first launch
// error (0 on success); a plan whose shared bytes disagree with this
// file's layout is refused as cudaErrorInvalidValue before any launch.
inline int launch(const WiserStepParams* p, void* stream) {
  Args a;
  a.doc = (const int32_t*)p->doc;
  a.n_doc = p->n_doc;
  a.score = (const float*)p->score;
  a.n_score = p->n_score;
  a.tf = (const int32_t*)p->tf;
  a.n_tf = p->n_tf;
  a.tc = (const uint16_t*)p->tc;
  a.n_tc = p->n_tc;
  a.starts = (const int32_t*)p->starts;
  a.ends = (const int32_t*)p->ends;
  a.weights = (const float*)p->weights;
  a.avg32 = (const float*)p->avg32;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.L = (int)p->L;
  a.M = (int)p->M;
  a.n_iters = (int)p->n_iters;
  a.ntiles = (int)p->ntiles;
  a.nseg = (int)p->nseg;
  a.tps = (int)p->tps;
  a.K = (int)p->K;
  a.KP = (int)p->KP;
  a.TL = (int)(p->G * p->LPT);
  a.lo_scratch = (int32_t*)p->lo_scratch;
  a.part_keys = (unsigned long long*)p->part_keys;
  a.part_src = (uint32_t*)p->part_src;
  a.plane = (float*)p->plane;
  a.sort_scratch = (unsigned long long*)p->sort_scratch;
  a.P = (int)p->P;
  a.top_docs = (int32_t*)p->top_docs;
  a.top_score = (float*)p->top_score;
  a.top_tfs = (int32_t*)p->top_tfs;
  a.top_pidx = (int32_t*)p->top_pidx;
  a.flags = (int32_t*)p->flags;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (p->path == 1) {
    dim3 grid((a.L + kThreads - 1) / kThreads, a.B);
    score_kernel<<<grid, kThreads, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem =
        a.sort_scratch ? 0 : (size_t)a.P * sizeof(unsigned long long);
    select_kernel<<<a.B, kThreads, smem, s>>>(a);
    return (int)cudaGetLastError();
  }
  const int G = (int)p->G;
  const bool multi = a.ntiles > 1;
  const long long smem =
      (kThreads / G) * worker_bytes(G, a.T, a.TL, a.KP, multi);
  const long long msmem = kMiscBytes + 3 * align8(a.KP * 12LL);
  if (smem != p->smem || (a.nseg > 1 && msmem != p->merge_smem) ||
      a.K > kKeyCap || a.K > a.KP)
    return (int)cudaErrorInvalidValue;
  const unsigned grid =
      G == 32 ? (unsigned)((a.B + kThreads / 32 - 1) / (kThreads / 32))
              : (unsigned)((long long)a.B * a.nseg);
  switch (G * 100 + (int)p->LPT) {
    case 3204: err = launch_tile<32, 4>(a, grid, smem, s); break;
    case 25601: err = launch_tile<256, 1>(a, grid, smem, s); break;
    case 25602: err = launch_tile<256, 2>(a, grid, smem, s); break;
    case 25604: err = launch_tile<256, 4>(a, grid, smem, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.nseg == 1) return (int)err;
  if (msmem > (48 << 10)) {
    err = cudaFuncSetAttribute(merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)msmem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_kernel<<<a.B, kThreads, msmem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace WISER_TILE_NS
