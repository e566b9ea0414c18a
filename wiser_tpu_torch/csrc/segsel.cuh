// The segmented selection shared by the semidense step (semidense.cu) and
// the semidense phrase route's selection (phrase_route.cu): each query's
// candidate lanes split into nseg segments, a CTA a segment, and the CTAs
// of a query one thread-block cluster (nseg <= 8, portable), whose
// segments' top K keys merge through distributed shared memory into the
// cluster's first CTA; no second launch and no device-memory scratch.
//
// A CTA takes the lanes [seg * seg_lanes, (seg + 1) * seg_lanes) of slot
// 0's run (the slice clamped as dynamic_slice clamps it), kStep lanes a
// step, kLPT lanes a thread:
//   - slots 1..nb-1 are searched: a lane's lower bound in the slot's run,
//     at most n_iters halvings (search_lower: the fixed-count search's
//     lower bound wherever its doc is found there, as tile.cuh's per-lane
//     search takes it), its payload added where the doc is found;
//   - every later slot is a dense other: one gather into its dense row
//     slots[b, t] at lane doc - doc_base, clamped into the row (raw: the
//     f32 score, matched where > 0; tc: the uint8 tf composed with the
//     candidate's len code, matched where > 0);
//   - a lane's f32 score sums s0 + (b1 + ... + bn) + d1 + d2 + ... (the
//     candidate's, the searched slots' among themselves, each dense
//     slot's in slot order; tc scores from dense.cu's device table);
//   - its 64-bit key (keys.cuh: score desc, lane asc, unique) is pushed
//     into select.cuh's unsorted buffer above the running threshold, cut
//     to the top K by a radix select when the buffer fills, sorted once.
// Keys are unique, so the merged top K of the segments' top K is the
// query's: ties at the K-th key, wherever their lanes fall, keep the
// lowest lanes, as the plain versions' stable sorts do.
//
// Every f32 operation is an explicit round-to-nearest intrinsic; the
// libraries that include this are built with -fmad=false.

#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "keys.cuh"
#include "select.cuh"

namespace wiser_segsel {

// the phase marks of a measuring build (clocks.cuh): 0 the candidates, 1
// the searched slots, 2 the dense gathers, 3 the pushes, flushes and the
// sort, 4 the including kernel's outputs, 5 the cluster merge; 6 counts
// the CTAs, 7 the merging ones, 11 the flushes
#include "clocks.cuh"

using namespace wiser_keys;
using namespace wiser_select;
namespace cg = cooperative_groups;

constexpr int kThreads = kSelThreads;  // a segment's CTA
constexpr int kLPT = kSelLPT;          // lanes a thread a step
constexpr int kStep = kThreads * kLPT;  // lanes a step
constexpr int kUnit = kThreads;  // segments hold whole units of lanes
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr int kSegMaxT = 16;     // slots a query at most

// The chained bi-bloom gate of the compact phrase route (select_segment's
// kGate): the sparse folded bloom columns (uint32 words as int32 bits)
// and the (B, C) probes (engine/kernels._bloom_gate).
struct GateArgs {
  const int32_t* bloom_rows;
  long long n_rows;
  const int32_t* bloom_bitmap;  // following side, then preceding side
  long long n_bitmap;
  const int32_t* bloom_rank;
  const int32_t* probe_slot;
  const uint8_t* probe_begins;
  const int32_t* probe_mask;
  const uint8_t* probe_active;
  int C;
};

struct SelArgs {
  const int32_t* doc;
  long long n_doc;
  const float* score;  // raw
  long long n_score;
  const uint16_t* tc;  // tc lanes; null on raw columns
  long long n_tc;
  const float* dense_sc;     // raw: (H, n_pad) f32
  const uint8_t* dense_tf8;  // tc: (H, n_pad) uint8
  long long n_pad, doc_base;
  const float* norm_g;    // tc: (256, 256), [tf * 256 + code]
  const int32_t* starts;  // (B, T)
  const int32_t* ends;    // (B, T)
  const float* weights;   // (B, T): use_score (raw) or idf32 (tc)
  const int32_t* slots;   // (B, T) dense rows of slots nb..T-1 (or null
                          // where nb = T)
  int B, T, L, nb, n_iters;
  // K keys kept a query, KP the power of 2 >= K, XC keys a CTA's buffer;
  // nseg CTAs a query of seg_lanes lanes each
  int K, KP, XC, nseg, seg_lanes;
  unsigned long long* xg;  // (B * nseg, XC) buffers where shared memory
                           // cannot hold them (nseg 1), else null
  GateArgs gate;           // read only by select_segment<..., true>
};

// The query's (B, T) rows, copied into shared memory once a CTA, so the
// step loop holds no pointer to them in a register (the buffer's flush
// is a call, across which every live register is kept).
struct QuerySmem {
  int st[kSegMaxT], en[kSegMaxT], sl[kSegMaxT];
  float w[kSegMaxT];
};

// A CTA's shared bytes ahead of its buffer: the flush's scratch, 4 step
// counters and the query's rows. ops/semidense.HEAD_BYTES is the same.
constexpr long long kFlushAt = 0;
constexpr long long kCntAt = ((sizeof(FlushSmem) + 15) / 16) * 16;
constexpr long long kQueryAt = kCntAt + 16;
constexpr long long kHead = kQueryAt + sizeof(QuerySmem);

__host__ __device__ constexpr long long sel_smem(int XC, bool global_x) {
  return kHead + (global_x ? 0 : 8LL * XC);
}

// A query's active probes, copied into shared memory once a CTA by the
// gated kernel (at kHead, ahead of its buffer: kGateBytes): probe c tests
// slot slot[c] (-1: inactive, it passes) at posting index + off[c] (the
// preceding side's Pw * 32, or 0) against mask[c].
struct GateSmem {
  long long off[kSegMaxT];
  int slot[kSegMaxT];
  unsigned mask[kSegMaxT];
};
constexpr long long kGateBytes = ((sizeof(GateSmem) + 15) / 16) * 16;

// Probe c's row of query b into g (threads tid < kSegMaxT; the caller's
// barrier publishes it): the probed slot clamped into [0, T), as the
// plain version's gather clamps it.
__device__ __forceinline__ void load_gate(const GateArgs& a, int b, int T,
                                          GateSmem& g, int tid) {
  if (tid >= kSegMaxT) return;
  int slot = -1;
  unsigned mask = 0;
  long long off = 0;
  if (tid < a.C) {
    const long long pc = (long long)b * a.C + tid;
    if (a.probe_active[pc]) {
      const int s = a.probe_slot[pc];
      slot = s < 0 ? 0 : (s > T - 1 ? T - 1 : s);
      mask = (unsigned)a.probe_mask[pc];
      off = a.probe_begins[pc] ? (a.n_bitmap / 2) * 32 : 0;
    }
  }
  g.off[tid] = off;
  g.slot[tid] = slot;
  g.mask[tid] = mask;
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

// the score of a tc lane (code8 << 8 | tf8) in a slot of this idf: the
// device table's entry times idf (bit for bit keys.cuh tc_score)
__device__ __forceinline__ float table_score(const float* norm_g, int lane,
                                             float idf) {
  return __fmul_rn(idf, __ldg(norm_g + (lane & 0xFF) * 256 +
                              ((lane >> 8) & 0xFF)));
}

// The first position in [lo, hi) whose doc is >= target after at most
// n_iters halvings (the fixed-count search's lower bound wherever it is
// found: tile.cuh lower_bound), reads clamped into the column.
__device__ __forceinline__ long long search_lower(const int32_t* doc,
                                                  long long n_doc,
                                                  int n_iters, int target,
                                                  long long lo,
                                                  long long hi) {
  for (int it = 0; it < n_iters && lo < hi; ++it) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (__ldg(doc + clampll(mid, 0, n_doc - 1)) < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Every active probe of slot t passes at posting index pq (kernels.
// _bloom_gate: the presence bit, the row's rank from bloom_rank plus the
// popcount below it, pass where (row & mask) == mask; an absent row
// prunes).
__device__ __forceinline__ bool gate_pass(const GateArgs& a,
                                          const GateSmem& g, int t,
                                          long long pq) {
  for (int c = 0; c < a.C; ++c) {
    if (g.slot[c] != t) continue;
    const long long sp = pq + g.off[c];
    const long long wi = clampll(sp >> 5, 0, a.n_bitmap - 1);
    const unsigned word = (unsigned)__ldg(a.bloom_bitmap + wi);
    const int bit = (int)(sp & 31);
    const unsigned below = word & ((1u << bit) - 1u);
    const long long rank = (long long)__ldg(a.bloom_rank + wi) + __popc(below);
    const unsigned row =
        (unsigned)__ldg(a.bloom_rows + clampll(rank, 0, a.n_rows - 1));
    if (!((word >> bit) & 1u) || (row & g.mask[c]) != g.mask[c]) return false;
  }
  return true;
}

__device__ __forceinline__ bool found_at(const int32_t* doc, long long n_doc,
                                         long long lo, long long end,
                                         int target) {
  return lo < end && __ldg(doc + clampll(lo, 0, n_doc - 1)) == target;
}

// This CTA's segment of query b: its top K keys, sorted descending and
// 0-padded to KP, in X[0, KP). kSearch: slots 1..nb-1 are searched (nb >
// 1); without it the searched slots' code is not compiled, and its
// registers not held. kGate (with kSearch): a lane must also pass the
// query's bi-bloom probes (load_gate's rows at smem + kHead), each at its
// slot's posting index (slot 0's cs + lane, as the plain version's int32
// sum), tested as soon as the slot is found. Every thread calls it; it
// ends with a barrier. smem: the CTA's kHead bytes (flush scratch,
// counters, the query's rows), then with kGate the probes' rows.
template <bool TC, bool kSearch, bool kGate = false>
__device__ __forceinline__ void select_segment(const SelArgs& a, int b,
                                               int seg, unsigned long long* X,
                                               unsigned char* smem,
                                               int tid) {
  static_assert(kSearch || !kGate, "the gate reads the searched slots");
  FlushSmem& fs = *reinterpret_cast<FlushSmem*>(smem + kFlushAt);
  int* cnt = reinterpret_cast<int*>(smem + kCntAt);
  QuerySmem& q = *reinterpret_cast<QuerySmem*>(smem + kQueryAt);
  const GateSmem& gs = *reinterpret_cast<const GateSmem*>(smem + kHead);
  volatile unsigned long long* const tau = &fs.tau;
  const int T = a.T, K = a.K, nb = a.nb;
  if (tid < T) {
    const long long o = (long long)b * T + tid;
    q.st[tid] = a.starts[o];
    q.en[tid] = a.ends[o];
    q.sl[tid] = a.slots ? a.slots[o] : 0;  // null: every slot searched
    q.w[tid] = a.weights[o];
  }
  if (tid < 4) cnt[tid] = 0;
  if (tid == 0) *tau = 0ull;
  __syncthreads();
  WCLK_START
  const int lane_lo = seg * a.seg_lanes;
  const int lane_hi = (int)min(clampll((long long)q.en[0] - q.st[0], 0, a.L),
                               (long long)lane_lo + a.seg_lanes);
  const float ninf = -__int_as_float(0x7f800000);
  const int xcap = a.XC;
  int base = 0;
  for (int lane0 = lane_lo, s = 0; lane0 < lane_hi; lane0 += kStep, ++s) {
    const long long cs = q.st[0];
    const long long s_doc = slice_start(cs, a.n_doc, a.L);
    const long long s_col = slice_start(cs, TC ? a.n_tc : a.n_score, a.L);
    const float w0 = q.w[0];
    int d[kLPT], code[kLPT];
    float acc[kLPT];
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < kLPT; ++j) {
      const int l = lane0 + j * kThreads + tid;
      d[j] = 0;
      code[j] = 0;
      acc[j] = 0.f;
      if (l < lane_hi) {
        live |= 1u << j;
        d[j] = __ldg(a.doc + s_doc + l);
        if (TC) {
          const int cl = __ldg(a.tc + s_col + l);
          if (!kSearch) code[j] = cl & 0xFF00;
          acc[j] = table_score(a.norm_g, cl, w0);
        } else {
          acc[j] = __fmul_rn(__ldg(a.score + s_col + l), w0);
        }
        if constexpr (kGate) {
          if (!gate_pass(a.gate, gs, 0,
                         (int)((unsigned)q.st[0] + (unsigned)l)))
            live &= ~(1u << j);
        }
      }
    }
    WCLK(0);
    if (kSearch) {
      // the searched slots: each live lane's lower bound, its payload
      // where the doc is found, the partials summed among themselves
      float part[kLPT];
      for (int t = 1; t < nb; ++t) {
        const long long s_t = q.st[t], e_t = q.en[t];
        const float wt = q.w[t];
#pragma unroll
        for (int j = 0; j < kLPT; ++j) {
          if (live >> j & 1) {
            const long long lo =
                search_lower(a.doc, a.n_doc, a.n_iters, d[j], s_t, e_t);
            if (!found_at(a.doc, a.n_doc, lo, e_t, d[j])) {
              live &= ~(1u << j);
            } else if (kGate && !gate_pass(a.gate, gs, t, lo)) {
              live &= ~(1u << j);
            } else {
              const float p =
                  TC ? table_score(a.norm_g,
                                   __ldg(a.tc + clampll(lo, 0, a.n_tc - 1)),
                                   wt)
                     : __fmul_rn(__ldg(a.score +
                                       clampll(lo, 0, a.n_score - 1)),
                                 wt);
              part[j] = t == 1 ? p : __fadd_rn(part[j], p);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kLPT; ++j)
        if (live >> j & 1) acc[j] = __fadd_rn(acc[j], part[j]);
    }
    WCLK(1);
    if (TC && kSearch) {
      // the len codes again, read back after the searches (held across
      // them they spilled registers)
#pragma unroll
      for (int j = 0; j < kLPT; ++j)
        if (live >> j & 1)
          code[j] = __ldg(a.tc + s_col + lane0 + j * kThreads + tid) & 0xFF00;
    }
    // the dense others in slot order: a slot's gathers go out together
    for (int t = nb; t < T; ++t) {
      const long long row = (long long)q.sl[t] * a.n_pad;
      const float wt = q.w[t];
      int pv[kLPT];
#pragma unroll
      for (int j = 0; j < kLPT; ++j) {
        pv[j] = 0;
        if (live >> j & 1) {
          const long long at =
              row + clampll((long long)d[j] - a.doc_base, 0, a.n_pad - 1);
          pv[j] = TC ? (int)__ldg(a.dense_tf8 + at)
                     : __float_as_int(__ldg(a.dense_sc + at));
        }
      }
#pragma unroll
      for (int j = 0; j < kLPT; ++j) {
        if (live >> j & 1) {
          const bool hold = TC ? pv[j] > 0 : __int_as_float(pv[j]) > 0.f;
          if (!hold) {
            live &= ~(1u << j);
          } else if (TC) {
            acc[j] = __fadd_rn(acc[j],
                               table_score(a.norm_g, code[j] | pv[j], wt));
          } else {
            acc[j] = __fadd_rn(acc[j], __fmul_rn(__int_as_float(pv[j]), wt));
          }
        }
      }
    }
    WCLK(2);
    unsigned long long key[kLPT];
#pragma unroll
    for (int j = 0; j < kLPT; ++j)
      key[j] = (live >> j & 1) && acc[j] != ninf
                   ? tile_key(acc[j], lane0 + j * kThreads + tid)
                   : 0ull;
    const int si = s % 3;
    push_keys(key, *tau, X, base, cnt + si);
    __syncthreads();
    // this step's counter is read by every thread before the next
    // barrier; the one two steps on was last read before this barrier
    const int c = base + cnt[si];
    if (tid == 0) cnt[(si + 2) % 3] = 0;
    if (c > xcap - kStep) {
      const unsigned long long t = keep_top(X, c, K, fs, tid);
      if (tid == 0) *tau = t;
      __syncthreads();
      base = K;
      WCLK_COUNT(11);
    } else {
      base = c;
    }
    WCLK(3);
  }
  __syncthreads();
  // the top K in order: up to kThreads keys ranked outright (a thread a
  // key), more cut to K by the radix select first
  int c = base;
  if (c > K && c > kThreads) {
    keep_top(X, c, K, fs, tid);
    c = K;
  }
  sort_keys<kThreads>(X, c, tid);
  for (int i = min(c, K) + tid; i < a.KP; i += kThreads) X[i] = 0ull;
  __syncthreads();
  WCLK(3);
}

// The query's top K once every segment holds its own (select_segment):
// with nseg > 1 the cluster's CTAs merge in a tree, ceil(log2 nseg)
// rounds: in round r a CTA whose segment is a multiple of 2^(r+1) copies
// its partner's list (segment + 2^r) out of distributed shared memory
// into Q = X + KP (one coalesced read; merge_ranks' searches then stay
// in its own shared memory), merges it with its own into X + 2 KP and
// copies the result back to X (XC >= 3 KP). The cluster's first CTA
// returns X, holding the query's list; the others return null once every
// round has read them. Every thread of every CTA of the cluster calls it.
__device__ __forceinline__ const unsigned long long* merge_segments(
    const SelArgs& a, unsigned long long* X, int seg, int tid) {
  if (a.nseg == 1) return X;
  cg::cluster_group cluster = cg::this_cluster();
  unsigned long long* Q = X + a.KP;
  unsigned long long* R2 = X + 2 * a.KP;
  WCLK_START
  for (int half = 1; half < a.nseg; half <<= 1) {
    cluster.sync();  // the partners' lists of the last round are whole
    if (seg % (2 * half) == 0 && seg + half < a.nseg) {
      const unsigned long long* P = cluster.map_shared_rank(X, seg + half);
      for (int i = tid; i < a.KP; i += kThreads) Q[i] = P[i];
      __syncthreads();
      const int n_in = list_length(Q, a.K);
      if (n_in > 0) {
        merge_ranks<kThreads, false>(X, nullptr, R2, nullptr, a.KP, Q,
                                     nullptr, n_in, 0u, tid);
        for (int i = tid; i < a.KP; i += kThreads) X[i] = R2[i];
        __syncthreads();
      }
    }
  }
  cluster.sync();  // every round has read its partner: they may exit
  if (seg == 0) {
    WCLK(5);
    WCLK_COUNT(7);
  }
  return seg == 0 ? X : nullptr;
}

// Launch kernel(args...) on a grid of B * nseg CTAs of kThreads, in
// clusters of nseg CTAs where nseg > 1, with smem dynamic shared bytes.
template <typename Kern, typename... Args>
cudaError_t launch_segments(Kern kernel, int B, int nseg, long long smem,
                            cudaStream_t s, Args... args) {
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)B * nseg));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nseg;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nseg > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The keys of a CTA's buffer for KP: two steps past KP (select.cuh's
// pushes), and where a query may split (KP <= 2 steps) three lists of KP
// (its own, its partner's copy, the merged one). ops/semidense.layout
// computes the same.
__host__ __device__ constexpr int buffer_keys(int KP) {
  return KP <= 2 * kStep && 3 * KP > KP + 2 * kStep ? 3 * KP
                                                     : KP + 2 * kStep;
}

// A plan's shape the kernels take: 1 <= nseg <= kMaxCluster whole
// segments of seg_lanes (a multiple of kUnit) covering L, a split only
// where the merge's three lists fit the buffer, the buffer's keys within
// shared memory or in device memory (nseg 1).
__host__ __device__ inline bool plan_ok(const SelArgs& a) {
  const int KP = a.KP;
  return a.K >= 1 && a.K <= KP && (KP & (KP - 1)) == 0 && KP / 2 < a.K &&
         a.XC >= KP + 2 * kStep && a.nseg >= 1 && a.nseg <= kMaxCluster &&
         a.seg_lanes >= kUnit && a.seg_lanes % kUnit == 0 &&
         (long long)a.seg_lanes * a.nseg >= a.L &&
         (long long)a.seg_lanes * (a.nseg - 1) < a.L &&
         (a.nseg == 1 || (a.XC >= 3 * KP && !a.xg)) && a.nb >= 1 &&
         a.nb <= a.T && a.T <= kSegMaxT && a.n_pad >= 1;
}

}  // namespace wiser_segsel
