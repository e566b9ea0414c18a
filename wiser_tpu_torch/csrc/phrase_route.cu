// Three phrase routes for Hopper (sm_90a): the semidense phrase route, the
// list chain and the compact route, each from the candidate slice to the
// packed (B, T+2, M) output with no torch stage between.
//
// Replaces, in wiser_tpu/engine/kernels.py (XLA-compiled jnp, not Pallas;
// dispatched at wiser_tpu/engine/device.py:2099, :2126 and :2148-2186):
//   - make_semidense_phrase_kernel (:840), raw and tc. Its eager torch
//     form (engine/kernels.semidense_phrase_torch, the plain version)
//     writes some ten (B, L) planes a group, a full stable sort of (B, L)
//     and (B, T-1, KV) search planes, L up to 32,768;
//   - the list chain (L <= KV): make_match_kernel (:465) and
//     make_match_kernel_tc (:363) with _bloom_gate (:403),
//     make_phrase_verify_kernel (:508), make_select_topk_kernel (:662) and
//     make_select_topk_kernel_tc (:442). Its plain version
//     (engine/kernels.list_phrase_torch) runs them as three calls with
//     torch steps between, over (B, L), (B, T, L) and (B, PP, L) planes;
//     without its gate (a compile-time switch) it is phrase_body (:554),
//     the mesh's list route (wiser_tpu/engine/shard.py:227, :618), with
//     the kept scores the mesh merges on;
//   - compact_phrase_body (:686; make_compact_phrase_kernel :785, the mesh's
//     make_sharded_compact_phrase_kernel, shard.py:487), raw and tc, L
//     2,048 to 32,768 on the resident engine and past 131,072 on a mesh
//     shard. Its plain version (engine/kernels.compact_phrase_body_torch)
//     writes (B, T-1, L) search planes, the gate's (B, C, L) gathers and a
//     stable sort of the whole (B, L) plane before its verification.
//
// The semidense phrase route, per query b (engine/kernels.py
// semidense_phrase_torch says the same in torch):
//   - every lane of slot 0's run (the slice clamped as dynamic_slice
//     clamps it) is a candidate; every other slot is a dense head: one
//     gather from its dense row slots[b, t] at the lane's doc (clamped into
//     the row). raw: the f32 score, matched where > 0; tc: the uint8 tf
//     composed with the candidate's len code, matched where > 0;
//   - the AND score sums s0 + d1 + d2 + ... in slot order (raw: score *
//     use; tc: idf * the device table's entry, dense.cu's tc_norm_kernel,
//     which equals tc_score bit for bit);
//   - sdp_select_kernel keeps the K = KV + 1 best keys (keys.cuh: score
//     desc, lane asc, so lax.top_k's order) by segsel.cuh's segmented
//     selection: a query's lanes in up to 8 segments of one cluster
//     (planned over the card's SMs, ops/semidense.segments), each keeping its
//     top K in select.cuh's unsorted shared-memory buffer, cut by its
//     radix select when it fills, sorted once; the segments merged in a
//     tree through distributed shared memory; no (B, L) plane;
//   - sdp_verify_kernel, a warp a (query, kept lane): the posting index
//     of each slot 1.. recovered over the slot's run by the warp's 32-ary
//     lower bound (bound.cuh: ~4 dependent rounds at 1M docs where a
//     binary search takes ~20) where the plain version's fixed-count
//     search has converged, else by a replay of that search (slot 0's is
//     cs + lane), so the indices agree everywhere; the bag
//     bounds from pos_starts in query-term order (slot_of), then
//     verify.cuh's window verification (phrase.cu's, anchor 0); it
//     writes the (B, KV) counts and the (B, T, KV) posting indices;
//   - sdp_output_kernel, a warp a query: the first M verified kept lanes
//     in key order are the top M (the plain version's stable top-M over
//     the ordered selection), FLAG_TRUNC where the (M+1)-th verified
//     ties the M-th, FLAG_PRUNE_MISS where the (KV+1)-th AND score
//     (`unseen`, which bounds every lane not verified) is > 0 and >= the
//     k-th kept score times f32(1 - eps3), the winners' tfs (raw:
//     postings_tf at the recovered indices; tc: the candidate's tf byte
//     and the dense tf bytes, FLAG_TF_SAT where one is 255), packed.
//
// The compact route, per query b: the semidense phrase route's three
// launches with another selection (cp_select_kernel): every slot 1.. is
// searched (segsel.cuh's searched slots, a lane's lower bound in the
// slot's run after the plain version's halvings), each found slot's
// probes of the chained bi-bloom gate tested at its posting index
// (kGate: the probes' rows in shared memory), the score s0 + (b1 + ...)
// in slot order, the KV + 1 best surviving keys kept by the segmented
// selection (a gated or unmatched lane leaves no key). The verification
// recovers the kept lanes' posting indices as the semidense route's does
// (a kept lane was found in every slot, so its fixed-count index is its
// lower bound); the output takes the tfs from the tc lanes at those
// indices (FLAG_TF_SAT from the candidate's slice byte and the searched
// slots' bytes, the plain version's sat_lane) and writes the (B, M) kept
// scores the mesh merges on. Nothing (B, L) or (B, T, L) reaches device
// memory.
//
// The list chain, per query b (list_kernel): the L <= 1,024 candidate
// lanes of slot 0, each searched in slots 1.. for its posting index as
// the plain version's fixed-count lower bound finds it (the score s0 +
// (b1 + b2 + ...)); with kGate the bi-bloom gate per probe (the probed
// slot's posting index, the following side first, the preceding side at
// + Pw * 32: presence word and bit, the row's rank from bloom_rank plus
// the popcount below, pass where (row & mask) == mask; an absent row
// prunes, an inactive probe passes); then the verification by binary
// search (bases: query term 0's first PP positions; term t's bag searched
// for base + t in n_pos_iters halvings, positions read as uint16 bits);
// then the top M of the verified lanes by key with FLAG_TRUNC and the
// tfs at the winners' posting indices (raw postings_tf; tc the tc lanes'
// bytes, with FLAG_TF_SAT from the lane's saturation), and the kept
// scores where asked. Without kGate (a compile-time switch) it is the
// bloomless chain of phrase_body, the mesh's list route. The design:
//   - a query's lanes lie in nseg segments of whole warps of lanes, a CTA
//     a segment, the CTAs of a query one cluster (at most 8), each about
//     one round of kThreads lanes where the card holds them
//     (ops/phrase_route.list_plan): the serve phase's B 8 groups no
//     longer run on 8 SMs, and a thread has one lane, not four, to search;
//   - a round: a thread a lane matches it (each slot's posting index by
//     the plain version's fixed-count search, so the indices and the
//     match are its own) and gates it; the round's active lanes are
//     compacted with their posting indices; a thread a (lane, term) reads
//     the bags and a thread a (lane, base) verifies, as the plain
//     version's kernels split the work. A group of 8 threads a lane
//     searching by bound.cuh's 8-ary bound was measured 2-3x slower at
//     the engine's B 128 groups (PERF.md §6): the binary search's upper
//     levels are shared by every lane and cached, and a group runs its
//     lanes in turn;
//   - a lane that verifies pushes its key, its T posting indices and its
//     saturation into the cluster's first CTA through distributed shared
//     memory; that CTA sorts only those c keys (cut to the top M + 1 by
//     select.cuh's radix select past 256) and writes the output, in the
//     one launch, with no device-memory scratch.
// Nothing (B, L) or (B, T, L) reaches device memory.
//
// A selection of one CTA a query ran under one wave at the engine's B <=
// 128 groups and 32 steps in series at L 32,768, and a recovery by the
// fixed-count search took 78% of a verification CTA's cycles; the list
// chain's first form (a CTA a query, four lanes a thread in turn)
// reached 0.2-0.3% of its bound at the engine's groups (PERF.md §6).
//
// Bound: bytes. The least the semidense phrase route must move is the
// candidate slice (8 bytes a lane raw, 6 tc), the 32-byte sectors of each
// dense row that the ascending docs touch, the K keys, and for the KV
// kept lanes the recovery's and the verification's reads; the list
// chain's: the candidate slice, each searched run once or one sector a
// probe where that is fewer, the probed bloom words and rows, the bags'
// sectors and the output; the compact route's: the list chain's match and
// gate, the K keys and the semidense route's kept-lane reads
// (tools/phrase_bench.*_bound_bytes). The
// searches are chains of dependent loads: latency, not bytes, is what
// the kernels wait on; the design keeps every (B, L) intermediate in
// registers or shared memory and runs many queries' chains at once.
//
// Arithmetic: every f32 operation is an explicit round-to-nearest
// intrinsic and the library is built with -fmad=false, so the scores
// equal the plain versions' bit for bit. Offsets are 64-bit.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "bound.cuh"
#include "keys.cuh"
#include "segsel.cuh"
#include "select.cuh"
#include "verify.cuh"

namespace wiser_phrase_route {

using namespace wiser_bound;
using namespace wiser_keys;
using namespace wiser_segsel;  // kThreads, the CTA of the selection and list
using namespace wiser_select;
namespace cg = cooperative_groups;

constexpr int kMaxT = 8;
constexpr int kListMaxL = 1024;  // the list chain's lanes: L <= KV
constexpr int kFlagPruneMiss = 8;
constexpr int kWarps = 8;  // the output kernel's queries a CTA

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) & ~15LL;
}

// ---------------------------------------------------------------------------
// The semidense phrase route.

struct SdpArgs {
  const int32_t* doc;
  long long n_doc;
  const float* score;  // raw
  long long n_score;
  const int32_t* tf;  // raw
  long long n_tf;
  const uint16_t* tc;  // tc lanes; null on raw columns
  long long n_tc;
  const float* dense_sc;     // raw: (H, n_pad)
  const uint8_t* dense_tf8;  // tc: (H, n_pad)
  long long n_pad;
  const float* norm_g;  // tc: (256, 256), [tf * 256 + code]
  const void* positions;
  long long n_pos;
  const int32_t* pos_starts;
  long long n_ps;
  const int32_t* starts;   // (B, T)
  const int32_t* ends;     // (B, T)
  const float* weights;    // (B, T): use_score (raw) or idf32 (tc)
  const int32_t* slots;    // (B, T) dense rows (slot 0 unread)
  const int32_t* slot_of;  // (B, T) query term -> slot
  const int32_t* ks;       // (B,)
  int B, T, L, KV, K, KP, PP, PW, M, n_iters;
  float keep;  // f32(1 - eps3)
  unsigned long long* keys;  // (B, K)
  int32_t* counts;           // (B, KV)
  int32_t* pidx;             // (B, T, KV), slot order
  int32_t* out;              // (B, T + 2, M)
  float* top_score;          // (B, M), or null
};

// The selection (segsel.cuh): a CTA a (query, segment), the CTAs of a
// query one cluster; the cluster's first CTA writes the query's K keys.
template <bool TC>
__global__ void __launch_bounds__(kThreads) sdp_select_kernel(
    SelArgs a, unsigned long long* keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* X =
      reinterpret_cast<unsigned long long*>(smem + kHead);
  const int b = blockIdx.x / a.nseg, seg = blockIdx.x % a.nseg;
  const int tid = threadIdx.x;
  select_segment<TC, false>(a, b, seg, X, smem, tid);
  const unsigned long long* R = merge_segments(a, X, seg, tid);
  if (!R) return;
  WCLK_START
  for (int i = tid; i < a.K; i += kThreads) keys[(long long)b * a.K + i] = R[i];
  WCLK(4);
  WCLK_COUNT(6);
}

// The compact route's selection: as sdp_select_kernel, every slot 1..
// searched (nb = T) and the query's bi-bloom probes tested on the way
// (select_segment's kGate), the probes' rows in shared memory ahead of
// the buffer.
template <bool TC>
__global__ void __launch_bounds__(kThreads) cp_select_kernel(
    SelArgs a, unsigned long long* keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  GateSmem& g = *reinterpret_cast<GateSmem*>(smem + kHead);
  unsigned long long* X =
      reinterpret_cast<unsigned long long*>(smem + kHead + kGateBytes);
  const int b = blockIdx.x / a.nseg, seg = blockIdx.x % a.nseg;
  const int tid = threadIdx.x;
  load_gate(a.gate, b, a.T, g, tid);  // select_segment's first barrier
  select_segment<TC, true, true>(a, b, seg, X, smem, tid);
  const unsigned long long* R = merge_segments(a, X, seg, tid);
  if (!R) return;
  WCLK_START
  for (int i = tid; i < a.K; i += kThreads) keys[(long long)b * a.K + i] = R[i];
  WCLK(4);
  WCLK_COUNT(6);
}

// A warp a (query, kept lane m < KV): recovery, bag bounds, verification.
template <bool kU16>
__global__ void __launch_bounds__(256) sdp_verify_kernel(SdpArgs a) {
  extern __shared__ __align__(16) int vsmem[];
  WCLK_START
  const int W = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * W + wid;
  if (item >= (long long)a.B * a.KV) return;  // the warp alone
  const int T = a.T, KV = a.KV;
  const int b = (int)(item / KV);
  const int m = (int)(item % KV);
  const unsigned long long key = a.keys[(long long)b * a.K + m];
  const long long po = (long long)b * T * KV + m;
  if (key == 0ull) {  // past the matched lanes: never read again
    if (l32 == 0) a.counts[item] = 0;
    if (l32 < T) a.pidx[po + (long long)l32 * KV] = 0;
    return;
  }
  const int32_t* st = a.starts + (long long)b * T;
  const int32_t* en = a.ends + (long long)b * T;
  const int lane = tile_key_lane(key);
  const long long cs = st[0];
  const int doc = a.doc[slice_start(cs, a.n_doc, a.L) + lane];
  // lane t holds slot t's posting index: each slot's found by the warp,
  // or by lane t's replay of the fixed-count search
  int p = l32 == 0 ? (int)((unsigned)cs + (unsigned)lane) : 0;
  bool replay = false;
  for (int t = 1; t < T; ++t) {
    const int r = recover(a.doc, a.n_doc, doc, st[t], en[t], a.n_iters, l32);
    if (l32 == t) {
      p = r;
      replay = r < 0;
    }
  }
  if (replay)
    p = search_fixed<0>(a.doc, a.n_doc, doc, st[l32], en[l32], a.n_iters);
  // lane t < T: query term t's bag, from its slot's posting index
  const int src =
      l32 < T ? (int)clampll(a.slot_of[(long long)b * T + l32], 0, T - 1) : 0;
  const int pq = __shfl_sync(0xffffffffu, p, src);
  long long s = 0, e = 0;
  if (l32 < T) {
    s = a.pos_starts[clampll(pq, 0, a.n_ps - 1)];
    e = a.pos_starts[clampll((long long)pq + 1, 0, a.n_ps - 1)];
  }
  WCLK(8);
  const int count = wiser_verify::warp_count<kU16>(
      a.positions, a.n_pos, s, e, T, a.PP, a.PW, 0,
      vsmem + (long long)wid * wiser_verify::warp_ints(T, a.PW), l32);
  if (l32 == 0) a.counts[item] = count;
  if (l32 < T) a.pidx[po + (long long)l32 * KV] = p;
  WCLK(9);
  WCLK_COUNT(10);
}

// The winners' tf source of the output kernel: raw postings_tf at the
// recovered posting indices; the semidense route's tc candidate byte and
// dense tf bytes; the compact route's tc lanes at the posting indices
// (saturation from the candidate's slice byte and the searched slots'
// lanes, as the plain version's sat_lane).
constexpr int kTfRaw = 0, kTfDense = 1, kTfLanes = 2;

// A warp a query: the top M of the verified kept lanes, the flags and the
// winners' tfs, packed, and their scores where top_score is given. Each
// warp keeps up to M + 1 chosen lanes.
template <int kTf>
__global__ void __launch_bounds__(kWarps * 32) sdp_output_kernel(SdpArgs a) {
  constexpr bool TC = kTf != kTfRaw;
  extern __shared__ __align__(16) int osmem[];
  WCLK_START
  const int wid = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + wid;
  if (b >= a.B) return;  // the warp alone
  const int T = a.T, M = a.M, KV = a.KV, K = a.K;
  int* sel = osmem + (long long)wid * (M + 1);
  const unsigned long long* keys = a.keys + (long long)b * K;
  const int32_t* counts = a.counts + (long long)b * KV;
  int nf = 0;
  for (int m0 = 0; m0 < KV && nf <= M; m0 += 32) {
    const int m = m0 + l32;
    const bool v = m < KV && keys[m] != 0ull && counts[m] > 0;
    const unsigned bal = __ballot_sync(0xffffffffu, v);
    const int at = nf + __popc(bal & ((1u << l32) - 1));
    if (v && at <= M) sel[at] = m;
    nf += __popc(bal);
  }
  nf = min(nf, M + 1);
  __syncwarp();
  const float ninf = -__int_as_float(0x7f800000);
  const long long cs = a.starts[(long long)b * T];
  const long long s_doc = slice_start(cs, a.n_doc, a.L);
  const long long s_col = slice_start(cs, TC ? a.n_tc : a.n_score, a.L);
  int32_t* out = a.out + (long long)b * (T + 2) * M;
  bool sat = false;
  for (int i = l32; i < M; i += 32) {
    int doc = -1, lane = 0, m = 0;
    if (i < nf) {
      m = sel[i];
      lane = tile_key_lane(keys[m]);
      doc = a.doc[s_doc + lane];
    }
    out[i] = doc;
    for (int t = 0; t < T; ++t) {
      int tf = 0;
      if (i < nf) {
        if (kTf == kTfLanes) {
          const long long p = a.pidx[((long long)b * T + t) * KV + m];
          tf = a.tc[clampll(p, 0, a.n_tc - 1)] & 0xFF;
          const int sb = t == 0 ? (a.tc[s_col + lane] & 0xFF) : tf;
          sat = sat || sb >= kTfSat;
        } else if (TC) {
          tf = t == 0 ? (a.tc[s_col + lane] & 0xFF)
                      : (int)a.dense_tf8[(long long)a.slots[(long long)b * T +
                                                             t] *
                                             a.n_pad +
                                         clampll(doc, 0, a.n_pad - 1)];
          sat = sat || tf >= kTfSat;
        } else {
          const long long p = a.pidx[((long long)b * T + t) * KV + m];
          tf = a.tf[clampll(p, 0, a.n_tf - 1)];
        }
      }
      out[(long long)(t + 1) * M + i] = tf;
    }
  }
  auto score = [&](int i) {
    return i < nf ? tile_key_score(keys[sel[i]]) : ninf;
  };
  int f = 0;
  if (nf > M) {
    const float s0 = score(M - 1), s1 = score(M);
    if (s0 > ninf && s1 == s0) f |= kFlagTrunc;
  }
  const float unseen =
      keys[KV] != 0ull ? tile_key_score(keys[KV]) : ninf;
  const int ki = (int)clampll((long long)a.ks[b] - 1, 0, M - 1);
  const float kth = score(ki);
  if (unseen > 0.f && unseen >= __fmul_rn(kth, a.keep)) f |= kFlagPruneMiss;
  if (__any_sync(0xffffffffu, sat)) f |= kFlagTfSat;
  for (int i = l32; i < M; i += 32) out[(long long)(T + 1) * M + i] = f;
  if (a.top_score)
    for (int i = l32; i < M; i += 32)
      a.top_score[(long long)b * M + i] = score(i);
  WCLK(12);
  WCLK_COUNT(13);
}

// ---------------------------------------------------------------------------
// The list chain.

constexpr int kListRound = 32;  // a segment holds whole warps of lanes

struct ListArgs {
  const int32_t* doc;
  long long n_doc;
  const float* score;  // raw
  long long n_score;
  const int32_t* tf;  // raw
  long long n_tf;
  const uint16_t* tc;  // tc lanes; null on raw columns
  long long n_tc;
  const float* norm_g;  // tc
  const void* positions;
  long long n_pos;
  const int32_t* pos_starts;
  long long n_ps;
  // the bi-bloom columns and the (B, C) probes (kGate)
  const int32_t* bloom_rows;
  long long n_rows;
  const int32_t* bloom_bitmap;
  long long n_bitmap;
  const int32_t* bloom_rank;
  const int32_t* probe_slot;
  const uint8_t* probe_begins;
  const int32_t* probe_mask;
  const uint8_t* probe_active;
  int C;
  const int32_t* starts;   // (B, T)
  const int32_t* ends;     // (B, T)
  const float* weights;    // (B, T)
  const int32_t* slot_of;  // (B, T)
  int B, T, L, PP, M, n_iters, n_pos_iters;
  int nseg, seg_lanes;  // CTAs a query (one cluster), lanes a CTA
  int32_t* out;         // (B, T + 2, M)
  float* top_score;     // (B, M), or null
};

// The query's (B, T) rows, copied into shared memory once a CTA.
struct ListQuery {
  int st[kMaxT], en[kMaxT], so[kMaxT];
  float w[kMaxT];
};

// The list kernel's shared bytes: 2 counters (16 B) | the query's rows
// (ListQuery) | a round's active lanes (at most kThreads): lane, score,
// verified count, saturation, then T posting indices (slot order) and T
// bag starts and ends (query-term order) each | the verified keys (the
// power of 2 >= L) | pidx (T, L) int32 by lane, slot order | saturation
// bytes (L) | a flush's scratch. Every CTA of a query pushes its verified
// lanes into the cluster's first CTA's keys, pidx and saturation; the
// others' go unused (a launch gives every CTA the same).
// ops/phrase_route.plan_list computes the same.
struct ListLayout {
  long long query, act, keys, pidx, sat, fs, total;
};

__host__ __device__ inline ListLayout list_layout(int T, int L) {
  ListLayout o;
  long long x = 16;
  o.query = x;
  x += align16(sizeof(ListQuery));
  o.act = x;
  x += 4LL * kThreads * (4 + 3 * T);
  o.keys = x;
  int P = 1;
  while (P < L) P <<= 1;
  x += 8LL * P;
  o.pidx = x;
  x += align16(4LL * T * L);
  o.sat = x;
  x += align16(L);
  o.fs = x;
  x += align16(sizeof(FlushSmem));
  o.total = x;
  return o;
}

// A CTA a (query, segment of seg_lanes lanes), the segments of a query one
// cluster, rounds of kThreads lanes: a thread a lane matches it (the plain
// version's fixed-count search in each slot) and gates it, the round's
// active lanes are compacted; then a thread a (active lane, term) reads
// its bag and a thread a (active lane, base) verifies; a thread a
// verified lane pushes its key, posting indices and saturation into the
// cluster's first CTA, which then takes the top M of the verified keys
// and writes the output.
template <bool TC, bool kGate, bool kU16>
__global__ void __launch_bounds__(kThreads, 1) list_kernel(ListArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, L = a.L, PP = a.PP;
  const ListLayout lay = list_layout(T, L);
  const int b = blockIdx.x / a.nseg, seg = blockIdx.x % a.nseg;
  const int tid = threadIdx.x;
  int* n_ver = reinterpret_cast<int*>(smem);
  int* n_act = n_ver + 1;
  ListQuery& q = *reinterpret_cast<ListQuery*>(smem + lay.query);
  // the round's active lanes
  int* act_lane = reinterpret_cast<int*>(smem + lay.act);
  float* act_score = reinterpret_cast<float*>(act_lane + kThreads);
  int* act_cnt = act_lane + 2 * kThreads;
  int* act_sat = act_lane + 3 * kThreads;
  int* act_mp = act_lane + 4 * kThreads;     // [a * T + slot]
  int* act_ps = act_mp + T * kThreads;       // [a * T + term]
  int* act_pe = act_ps + T * kThreads;
  unsigned long long* X =
      reinterpret_cast<unsigned long long*>(smem + lay.keys);
  int32_t* s_pidx = reinterpret_cast<int32_t*>(smem + lay.pidx);
  uint8_t* s_sat = smem + lay.sat;
  if (tid < T) {
    const long long o = (long long)b * T + tid;
    q.st[tid] = a.starts[o];
    q.en[tid] = a.ends[o];
    q.so[tid] = (int)clampll(a.slot_of[o], 0, T - 1);
    q.w[tid] = a.weights[o];
  }
  if (tid == 0) *n_ver = 0;
  // where the lanes go: the cluster's first CTA's count and arrays
  int* lead_n = n_ver;
  unsigned long long* lead_X = X;
  int32_t* lead_pidx = s_pidx;
  uint8_t* lead_sat = s_sat;
  if (a.nseg > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    lead_n = cluster.map_shared_rank(n_ver, 0);
    lead_X = cluster.map_shared_rank(X, 0);
    lead_pidx = cluster.map_shared_rank(s_pidx, 0);
    lead_sat = cluster.map_shared_rank(s_sat, 0);
    cluster.sync();  // the first CTA's count is zeroed
  } else {
    __syncthreads();
  }
  WCLK_START
  const long long cs = q.st[0];
  const int n_valid = (int)clampll((long long)q.en[0] - cs, 0, L);
  const long long s_doc = slice_start(cs, a.n_doc, L);
  const long long s_col = slice_start(cs, TC ? a.n_tc : a.n_score, L);
  const int lane_hi = min(n_valid, (seg + 1) * a.seg_lanes);
  const float w0 = q.w[0];
  for (int r0 = seg * a.seg_lanes; r0 < lane_hi; r0 += kThreads) {
    if (tid == 0) *n_act = 0;
    __syncthreads();
    // match: the lane against slots 1.., each slot's posting index kept
    const int l = r0 + tid;
    if (l < lane_hi) {
      const int d = a.doc[s_doc + l];
      bool sat = false;
      float s0;
      if (TC) {
        const int cl = a.tc[s_col + l];
        s0 = table_score(a.norm_g, cl, w0);
        sat = (cl & 0xFF) >= kTfSat;
      } else {
        s0 = __fmul_rn(a.score[s_col + l], w0);
      }
      int mp[kMaxT];
      mp[0] = (int)((unsigned)cs + (unsigned)l);
      bool alive = true;
      float acc = 0.f;
#pragma unroll
      for (int t = 1; t < kMaxT; ++t) {
        mp[t] = 0;
        if (t >= T || !alive) continue;
        const int r = search_fixed<0>(a.doc, a.n_doc, d, q.st[t], q.en[t],
                                      a.n_iters);
        mp[t] = r;
        alive = r < q.en[t] && a.doc[clampll(r, 0, a.n_doc - 1)] == d;
        if (!alive) continue;
        float p;
        if (TC) {
          const int h = a.tc[clampll(r, 0, a.n_tc - 1)];
          p = table_score(a.norm_g, h, q.w[t]);
          sat = sat || (h & 0xFF) >= kTfSat;
        } else {
          p = __fmul_rn(a.score[clampll(r, 0, a.n_score - 1)], q.w[t]);
        }
        acc = t == 1 ? p : __fadd_rn(acc, p);
      }
      if constexpr (kGate) {
        // the bi-bloom gate: every active probe of the query must pass
        const int Pw = (int)(a.n_bitmap / 2);
        for (int c = 0; c < a.C && alive; ++c) {
          const long long pc = (long long)b * a.C + c;
          if (!a.probe_active[pc]) continue;
          const int slot = (int)clampll(a.probe_slot[pc], 0, T - 1);
          int pq = mp[0];
#pragma unroll
          for (int t = 1; t < kMaxT; ++t) pq = slot == t ? mp[t] : pq;
          const long long sp =
              (long long)pq + (a.probe_begins[pc] ? (long long)Pw * 32 : 0);
          const long long wi = clampll(sp >> 5, 0, a.n_bitmap - 1);
          const unsigned word = (unsigned)a.bloom_bitmap[wi];
          const int bit = (int)(sp & 31);
          const bool present = (word >> bit) & 1u;
          const unsigned below = word & ((1u << bit) - 1u);
          const long long rank = (long long)a.bloom_rank[wi] + __popc(below);
          const unsigned row =
              (unsigned)a.bloom_rows[clampll(rank, 0, a.n_rows - 1)];
          const unsigned mask = (unsigned)a.probe_mask[pc];
          alive = present && (row & mask) == mask;
        }
      }
      if (alive) {
        const int i = atomicAdd(n_act, 1);
        act_lane[i] = l;
        act_score[i] = __fadd_rn(s0, acc);
        act_sat[i] = sat;
#pragma unroll
        for (int t = 0; t < kMaxT; ++t)
          if (t < T) act_mp[i * T + t] = mp[t];
      }
    }
    __syncthreads();
    WCLK(14);
    // each active lane's bags in query-term order, its count zeroed
    const int na = *n_act;
    for (int i = tid; i < na * T; i += kThreads) {
      const int x = i / T, t = i % T;
      const int pq = act_mp[x * T + q.so[t]];
      act_ps[i] = a.pos_starts[clampll(pq, 0, a.n_ps - 1)];
      act_pe[i] = a.pos_starts[clampll((long long)pq + 1, 0, a.n_ps - 1)];
      if (t == 0) act_cnt[x] = 0;
    }
    __syncthreads();
    WCLK(15);
    // the verification, a thread a (active lane, base): the base is valid
    // while it lies in term 0's bag; term t must hold base + t, found by
    // the fixed-count search over its bag
    for (int i = tid; i < na * PP; i += kThreads) {
      const int x = i / PP, p = i % PP;
      const int* ps = act_ps + x * T;
      const int* pe = act_pe + x * T;
      const int bi = (int)((unsigned)ps[0] + (unsigned)p);
      if (!(bi < pe[0])) continue;
      const int base = wiser_verify::position<kU16>(
          a.positions, clampll(bi, 0, a.n_pos - 1));
      bool ok = true;
      for (int t = 1; t < T && ok; ++t) {
        const int tgt = base + t;
        const int lo = search_fixed<kU16 ? 1 : 2>(a.positions, a.n_pos, tgt,
                                                  ps[t], pe[t],
                                                  a.n_pos_iters);
        ok = lo < pe[t] &&
             wiser_verify::position<kU16>(
                 a.positions, clampll(lo, 0, a.n_pos - 1)) == tgt;
      }
      if (ok) atomicAdd(act_cnt + x, 1);
    }
    __syncthreads();
    WCLK(16);
    // a verified lane's key, posting indices and saturation into the
    // cluster's first CTA
    for (int i = tid; i < na * T; i += kThreads) {
      const int x = i / T, t = i % T;
      if (act_cnt[x] <= 0) continue;
      const int lane = act_lane[x];
      if (t == 0) {
        lead_X[atomicAdd(lead_n, 1)] = tile_key(act_score[x], lane);
        lead_sat[lane] = act_sat[x];
      }
      lead_pidx[t * L + lane] = act_mp[x * T + t];
    }
    __syncthreads();  // the round's arrays are read
    WCLK(17);
  }
  if (a.nseg > 1) {
    cg::this_cluster().sync();  // every lane is in the first CTA
  } else {
    __syncthreads();
  }
  WCLK(18);
  WCLK_COUNT(20);
  if (seg != 0) return;

  // the top M of the c verified keys by (score desc, lane asc): past a
  // thread a key, cut to the top M + 1 by the radix select first
  int c = *n_ver;
  const int M = a.M;
  if (c > kThreads && c > M + 1) {
    keep_top(X, c, M + 1, *reinterpret_cast<FlushSmem*>(smem + lay.fs),
             tid);
    c = M + 1;
  }
  sort_keys<kThreads>(X, c, tid);
  int32_t* out = a.out + (long long)b * (T + 2) * M;
  bool sat = false;
  float* top_score = a.top_score ? a.top_score + (long long)b * M : nullptr;
  for (int m = tid; m < M; m += kThreads) {
    const bool kept = m < c;
    const int lane = kept ? tile_key_lane(X[m]) : 0;
    out[m] = kept ? a.doc[s_doc + lane] : -1;
    if (top_score)
      top_score[m] = kept ? tile_key_score(X[m]) : -__int_as_float(0x7f800000);
    for (int t = 0; t < T; ++t) {
      int tf = 0;
      if (kept) {
        const long long p = s_pidx[t * L + lane];
        tf = TC ? (a.tc[clampll(p, 0, a.n_tc - 1)] & 0xFF)
                : a.tf[clampll(p, 0, a.n_tf - 1)];
      }
      out[(long long)(t + 1) * M + m] = tf;
    }
    if (TC && kept) sat = sat || s_sat[lane];
  }
  const int any_sat = __syncthreads_or(sat);
  int f = 0;
  if (c > M && tile_key_score(X[M]) == tile_key_score(X[M - 1]))
    f |= kFlagTrunc;
  if (any_sat) f |= kFlagTfSat;
  for (int m = tid; m < M; m += kThreads) out[(long long)(T + 1) * M + m] = f;
  WCLK(19);
  WCLK_COUNT(21);
}

template <typename Kern, typename Args>
cudaError_t launch(Kern kern, unsigned grid, unsigned threads, long long smem,
                   const Args& a, cudaStream_t s) {
  if (smem > (48 << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, (size_t)smem, s>>>(a);
  return cudaGetLastError();
}

template <bool TC, bool kGate>
cudaError_t launch_list(const ListArgs& a, bool u16, long long smem,
                        cudaStream_t s) {
  return u16 ? launch_segments(list_kernel<TC, kGate, true>, a.B, a.nseg,
                               smem, s, a)
             : launch_segments(list_kernel<TC, kGate, false>, a.B, a.nseg,
                               smem, s, a);
}

}  // namespace wiser_phrase_route

// ops/phrase_route._SdpParams: every field 8 bytes (keep: the f32 bits).
// The semidense phrase route and the compact route share it: the dense
// fields are the semidense route's, the bloom and probe fields the
// compact route's (0 where unread).
struct WiserSdpParams {
  long long doc, n_doc, score, n_score, tf, n_tf, tc, n_tc;
  long long dense_sc, dense_tf8, n_pad, norm_g;
  long long positions, n_pos, u16, pos_starts, n_ps;
  long long starts, ends, weights, slots, slot_of, ks;
  long long B, T, L, KV, K, KP, PP, PW, M, n_iters, keep_bits;
  long long keys, counts, pidx, out;
  long long W, smem_select, smem_verify, smem_output, nseg, seg_lanes;
  long long top_score, bloom_rows, n_rows, bloom_bitmap, n_bitmap;
  long long bloom_rank, probe_slot, probe_begins, probe_mask, probe_active;
  long long C;
};

namespace wiser_phrase_route {

// The verification's and the output's view of the params.
inline SdpArgs sdp_args(const WiserSdpParams* p) {
  SdpArgs a;
  a.doc = (const int32_t*)p->doc;
  a.n_doc = p->n_doc;
  a.score = (const float*)p->score;
  a.n_score = p->n_score;
  a.tf = (const int32_t*)p->tf;
  a.n_tf = p->n_tf;
  a.tc = (const uint16_t*)p->tc;
  a.n_tc = p->n_tc;
  a.dense_sc = (const float*)p->dense_sc;
  a.dense_tf8 = (const uint8_t*)p->dense_tf8;
  a.n_pad = p->n_pad;
  a.norm_g = (const float*)p->norm_g;
  a.positions = (const void*)p->positions;
  a.n_pos = p->n_pos;
  a.pos_starts = (const int32_t*)p->pos_starts;
  a.n_ps = p->n_ps;
  a.starts = (const int32_t*)p->starts;
  a.ends = (const int32_t*)p->ends;
  a.weights = (const float*)p->weights;
  a.slots = (const int32_t*)p->slots;
  a.slot_of = (const int32_t*)p->slot_of;
  a.ks = (const int32_t*)p->ks;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.L = (int)p->L;
  a.KV = (int)p->KV;
  a.K = (int)p->K;
  a.KP = (int)p->KP;
  a.PP = (int)p->PP;
  a.PW = (int)p->PW;
  a.M = (int)p->M;
  a.n_iters = (int)p->n_iters;
  const unsigned kb = (unsigned)p->keep_bits;
  std::memcpy(&a.keep, &kb, sizeof(float));
  a.keys = (unsigned long long*)p->keys;
  a.counts = (int32_t*)p->counts;
  a.pidx = (int32_t*)p->pidx;
  a.out = (int32_t*)p->out;
  a.top_score = (float*)p->top_score;
  return a;
}

// The selection's view of the params: nb slots searched (1: none), the
// rest dense heads.
inline SelArgs sel_args(const WiserSdpParams* p, const SdpArgs& a, int nb) {
  SelArgs sel;
  sel.doc = a.doc;
  sel.n_doc = a.n_doc;
  sel.score = a.score;
  sel.n_score = a.n_score;
  sel.tc = a.tc;
  sel.n_tc = a.n_tc;
  sel.dense_sc = a.dense_sc;
  sel.dense_tf8 = a.dense_tf8;
  sel.n_pad = a.n_pad;
  sel.doc_base = 0;
  sel.norm_g = a.norm_g;
  sel.starts = a.starts;
  sel.ends = a.ends;
  sel.weights = a.weights;
  sel.slots = a.slots;
  sel.B = a.B;
  sel.T = a.T;
  sel.L = a.L;
  sel.nb = nb;
  sel.n_iters = nb > 1 ? a.n_iters : 0;
  sel.K = a.K;
  sel.KP = a.KP;
  sel.XC = buffer_keys(a.KP);
  sel.nseg = (int)p->nseg;
  sel.seg_lanes = (int)p->seg_lanes;
  sel.xg = nullptr;
  GateArgs& g = sel.gate;
  g.bloom_rows = (const int32_t*)p->bloom_rows;
  g.n_rows = p->n_rows;
  g.bloom_bitmap = (const int32_t*)p->bloom_bitmap;
  g.n_bitmap = p->n_bitmap;
  g.bloom_rank = (const int32_t*)p->bloom_rank;
  g.probe_slot = (const int32_t*)p->probe_slot;
  g.probe_begins = (const uint8_t*)p->probe_begins;
  g.probe_mask = (const int32_t*)p->probe_mask;
  g.probe_active = (const uint8_t*)p->probe_active;
  g.C = (int)p->C;
  return sel;
}

// The kept lanes' verification and the output: two launches.
template <int kTf>
cudaError_t launch_verify_output(const WiserSdpParams* p, const SdpArgs& a,
                                 cudaStream_t s) {
  const int W = (int)p->W;
  const long long items = (long long)a.B * a.KV;
  const unsigned vgrid = (unsigned)((items + W - 1) / W);
  cudaError_t err = p->u16 ? launch(sdp_verify_kernel<true>, vgrid, W * 32,
                                    p->smem_verify, a, s)
                           : launch(sdp_verify_kernel<false>, vgrid, W * 32,
                                    p->smem_verify, a, s);
  if (err != cudaSuccess) return err;
  const unsigned ogrid = (unsigned)((a.B + kWarps - 1) / kWarps);
  return launch(sdp_output_kernel<kTf>, ogrid, kWarps * 32, p->smem_output,
                a, s);
}

// The checks both routes' verification and output share.
inline bool tail_ok(const WiserSdpParams* p, const SdpArgs& a) {
  const int W = (int)p->W;
  return a.T >= 2 && a.T <= kMaxT && a.K == a.KV + 1 && a.M >= 1 &&
         a.M <= a.KV && a.PP >= 1 && a.PW >= 1 && W >= 1 && W <= 8 &&
         p->smem_verify == 4LL * W * wiser_verify::warp_ints(a.T, a.PW) &&
         p->smem_output == 4LL * kWarps * (a.M + 1);
}

}  // namespace wiser_phrase_route

extern "C" {

// The semidense phrase route on `stream` (no synchronize): three
// launches. Returns the first launch error (0 on success); a plan that
// disagrees with this file's layout is refused as cudaErrorInvalidValue.
int wiser_semidense_phrase(const WiserSdpParams* p, void* stream) {
  using namespace wiser_phrase_route;
  const SdpArgs a = sdp_args(p);
  const bool tc = a.tc != nullptr;
  // the selection's view: the candidate, every other slot a dense head
  const SelArgs sel = sel_args(p, a, 1);
  if (!tail_ok(p, a) || !plan_ok(sel) ||
      (tc ? !a.dense_tf8 || !a.norm_g : !a.dense_sc || !a.score || !a.tf) ||
      p->smem_select != sel_smem(sel.XC, false))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      tc ? launch_segments(sdp_select_kernel<true>, a.B, sel.nseg,
                           p->smem_select, s, sel, a.keys)
         : launch_segments(sdp_select_kernel<false>, a.B, sel.nseg,
                           p->smem_select, s, sel, a.keys);
  if (err != cudaSuccess) return (int)err;
  return (int)(tc ? launch_verify_output<kTfDense>(p, a, s)
                  : launch_verify_output<kTfRaw>(p, a, s));
}

// The compact phrase route on `stream` (no synchronize): three launches,
// the selection every slot searched and gated (cp_select_kernel), then
// the semidense route's verification and output (tc: tfs from the tc
// lanes). Returns the first launch error (0 on success); a plan that
// disagrees with this file's layout is refused as cudaErrorInvalidValue.
int wiser_compact_phrase(const WiserSdpParams* p, void* stream) {
  using namespace wiser_phrase_route;
  const SdpArgs a = sdp_args(p);
  const bool tc = a.tc != nullptr;
  const SelArgs sel = sel_args(p, a, a.T);
  const GateArgs& g = sel.gate;
  if (!tail_ok(p, a) || !plan_ok(sel) || a.L <= a.KV ||
      (tc ? !a.norm_g : !a.score || !a.tf) || g.C < 0 || g.C > kSegMaxT ||
      (g.C > 0 && (!g.bloom_rows || g.n_rows < 1 || !g.bloom_bitmap ||
                   g.n_bitmap < 2 || !g.bloom_rank || !g.probe_slot ||
                   !g.probe_begins || !g.probe_mask || !g.probe_active)) ||
      p->smem_select != sel_smem(sel.XC, false) + kGateBytes)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      tc ? launch_segments(cp_select_kernel<true>, a.B, sel.nseg,
                           p->smem_select, s, sel, a.keys)
         : launch_segments(cp_select_kernel<false>, a.B, sel.nseg,
                           p->smem_select, s, sel, a.keys);
  if (err != cudaSuccess) return (int)err;
  return (int)(tc ? launch_verify_output<kTfLanes>(p, a, s)
                  : launch_verify_output<kTfRaw>(p, a, s));
}

// ops/phrase_route._ListParams: every field 8 bytes.
struct WiserListParams {
  long long doc, n_doc, score, n_score, tf, n_tf, tc, n_tc, norm_g;
  long long positions, n_pos, u16, pos_starts, n_ps;
  long long bloom_rows, n_rows, bloom_bitmap, n_bitmap, bloom_rank;
  long long probe_slot, probe_begins, probe_mask, probe_active, C, gate;
  long long starts, ends, weights, slot_of;
  long long B, T, L, PP, M, n_iters, n_pos_iters, out, smem, nseg;
  long long seg_lanes, top_score;
};

// The list chain on `stream` (no synchronize): one launch, a query's nseg
// segments one cluster. gate 0 leaves the bloom gate out (the bloomless
// chain). Returns the launch error (0 on success); a plan that disagrees
// with this file's layout is refused as cudaErrorInvalidValue.
int wiser_list_phrase(const WiserListParams* p, void* stream) {
  using namespace wiser_phrase_route;
  ListArgs a;
  a.doc = (const int32_t*)p->doc;
  a.n_doc = p->n_doc;
  a.score = (const float*)p->score;
  a.n_score = p->n_score;
  a.tf = (const int32_t*)p->tf;
  a.n_tf = p->n_tf;
  a.tc = (const uint16_t*)p->tc;
  a.n_tc = p->n_tc;
  a.norm_g = (const float*)p->norm_g;
  a.positions = (const void*)p->positions;
  a.n_pos = p->n_pos;
  a.pos_starts = (const int32_t*)p->pos_starts;
  a.n_ps = p->n_ps;
  a.bloom_rows = (const int32_t*)p->bloom_rows;
  a.n_rows = p->n_rows;
  a.bloom_bitmap = (const int32_t*)p->bloom_bitmap;
  a.n_bitmap = p->n_bitmap;
  a.bloom_rank = (const int32_t*)p->bloom_rank;
  a.probe_slot = (const int32_t*)p->probe_slot;
  a.probe_begins = (const uint8_t*)p->probe_begins;
  a.probe_mask = (const int32_t*)p->probe_mask;
  a.probe_active = (const uint8_t*)p->probe_active;
  a.C = (int)p->C;
  a.starts = (const int32_t*)p->starts;
  a.ends = (const int32_t*)p->ends;
  a.weights = (const float*)p->weights;
  a.slot_of = (const int32_t*)p->slot_of;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.L = (int)p->L;
  a.PP = (int)p->PP;
  a.M = (int)p->M;
  a.n_iters = (int)p->n_iters;
  a.n_pos_iters = (int)p->n_pos_iters;
  a.out = (int32_t*)p->out;
  a.nseg = (int)p->nseg;
  a.seg_lanes = (int)p->seg_lanes;
  a.top_score = (float*)p->top_score;
  const bool tc = a.tc != nullptr, gate = p->gate != 0;
  if (a.T < 2 || a.T > kMaxT || a.L < 1 || a.L > kListMaxL || a.M < 1 ||
      a.M > a.L || a.PP < 1 || !a.norm_g == tc || a.nseg < 1 ||
      a.nseg > kMaxCluster ||
      a.seg_lanes < kListRound || a.seg_lanes % kListRound ||
      (long long)a.seg_lanes * a.nseg < a.L ||
      (long long)a.seg_lanes * (a.nseg - 1) >= a.L ||
      (!tc && (!a.score || !a.tf)) ||
      (gate && (a.C < 0 || a.n_rows < 1 || a.n_bitmap < 2)) ||
      p->smem != list_layout(a.T, a.L).total)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tc) {
    err = gate ? launch_list<true, true>(a, p->u16, p->smem, s)
               : launch_list<true, false>(a, p->u16, p->smem, s);
  } else {
    err = gate ? launch_list<false, true>(a, p->u16, p->smem, s)
               : launch_list<false, false>(a, p->u16, p->smem, s);
  }
  return (int)err;
}


const char* wiser_phrase_route_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

WISER_CLOCKS_READER(wiser_phrase_route_clocks, wiser_segsel)
