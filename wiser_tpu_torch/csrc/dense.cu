// The dense head-term tier for Hopper (sm_90a): the block-list scan and
// the block pick.
//
// Replaces, in wiser_tpu/engine/kernels.py (XLA-compiled jnp, not Pallas;
// XLA fused these steps on the TPU, and their eager torch forms in
// engine/kernels.py, the plain versions, write every intermediate plane to
// device memory):
//   - make_dense_search_kernel (:1863) and make_dense_search_kernel_tc
//     (:1061), the doc-space scan of all-head conjunctions (port
//     dense_scan_body{,_tc}), with two_level_top_m (:284) and
//     boundary_truncated (:188);
//   - the scan half of _pruned_dense_body (:1340, make_pruned_dense_kernel
//     {,_tc} :1393, :1425): the same scan over the C picked blocks (port
//     pruned_scan_body);
//   - _select_ub_blocks (:1222): per-block joint upper bounds and the
//     stable top-(C+1) block pick.
//
// scan_kernel: per query b, over a lane set (every 128-doc block of the
// (H, N_pad) plane, or the C ascending blocks of a (B, C) list), each
// lane's value in row slots[b, t]: raw the f32 score, tc the uint8 tf
// composed with the shared len-code row (tf > 0 ? code << 8 | tf : 0). A
// lane is matched when every slot's value is > 0; its f32 score is 0.0
// plus one term a slot, in slot order: raw v * w, tc tc_score(v, idf,
// avg). The top M matched lanes by (score desc, doc asc) are kept (doc -1,
// score -inf, tfs 0 past the last match); FLAG_TRUNC when the M-th score
// is > -inf and the (M+1)-th equals it; the winners' per-slot tfs (raw the
// i32 tf plane, tc the tf byte) and FLAG_TF_SAT (tc) when a kept lane's
// tf byte is 255.
//
// Bound: bytes. The least the scan must move is each distinct (row,
// block) payload its queries read, once (4 B a lane raw, 1 B tc, plus the
// len-code row's blocks once in tc), the (B, T) slots and weights, the
// winners' tf loads and the outputs (tools/dense_bench.bound_bytes); the
// arithmetic is a few operations a byte once tc's divisions leave the
// lane loop. The design:
//   - a CTA of 256 threads takes a (segment of blocks, query) pair. Its
//     prologue finds the query's distinct rows (a padded slot repeats
//     slot 0's row); each step of up to 8 blocks (1,024 lanes) brings
//     every distinct row's segment, and in tc the len-code row's, into a
//     ring of 2-4 shared-memory stages, so the next steps' loads are in
//     flight while one is consumed. Over every block the copies are
//     cp.async.bulk (TMA's 1-D bulk copy), one a row segment, issued by
//     warp 0, each stage completing on its own mbarrier; warp 0 refills
//     a stage right after the step's barrier, which every thread passes
//     only once it has read that stage (that barrier is the step's key
//     count's, needed anyway), so no empty barriers and no producer warp
//     are needed. Over a block list (the pruned scan; the segment's
//     block ids read into shared memory first) each thread copies its
//     own lanes of each row with 16-byte (tc: 4-byte) cp.async, one
//     commit group a step, NS - 1 steps ahead, and waits for its own
//     copies alone: there the bulk copies, one a (row, block) of 128 or
//     512 bytes, held warp 0 and every step's barrier up (PERF.md §6);
//   - each thread scores 4 lanes from shared memory, summing and masking
//     in registers. No tc lane divides: each CTA fills exact tables from
//     avg32 in its prologue (keys.cuh tc_fill_tables: the length term of
//     the 256 len codes, and the tf part of the score for tf < kTft of
//     each), and a lane whose tf byte is kTft or more reads the tf part
//     from the (tf byte, len code) table tc_norm_kernel writes to device
//     memory before the scan (255 its fixed bound there). Every entry is
//     the division path's own helper (keys.cuh tc_norm), so a lane costs
//     one multiply by idf and equals that path's score bit for bit;
//   - the matched lanes whose 64-bit key (keys.cuh: ordered score bits
//     above the inverted doc) passes the running K-th key (K = M + 1) are
//     compacted into the key buffer (one atomic a warp and lane slot);
//     when the buffer holds a step's worth of keys, its K-th key is found
//     by a radix select and the K keys at or above it ranked (K > 256:
//     the buffer sorted whole), then merged by rank into the running top
//     K, which raises the threshold (the running lists in shared memory
//     up to 4,096 keys, past that in a device scratch, so any M runs); no
//     (B, N_pad) or (B, C * 128) plane ever reaches device memory;
//   - keys are unique, so ties fall to the lowest doc on every row, the
//     set is exact at every lane-set size, and FLAG_TRUNC reads the
//     (M+1)-th key;
//   - the plan (ops/dense.plan) splits each query's blocks into nseg
//     segments so that the grid's CTAs come to whole waves of the card's
//     resident slots; each segment leaves its K keys, and a second launch
//     (merge_kernel) streams the other segments' keys of a query through
//     the same threshold, compaction and merge. The winners' tfs come
//     from the keys' docs, with no second pass over the lanes.
//
// pick_kernel: a query's bounds come from nsplit CTAs, each over a slice
// of the NB blocks (nsplit > 1 only for a group too small to fill the
// card; its bounds go to a device scratch and the last CTA of the query
// to finish, counted on a zeroed word, selects); each thread loads a
// block's bm, bm2 and ap of every slot once into registers (T <= 8) and
// computes: raw the plain sum bm_0 * w_0 + bm_1 * w_1 + ... in slot order;
// with blockmax2 and argpos the max over anchors ts of bm_ts * w_ts + sum
// over t != ts, in slot order, of (argpos_t == argpos_ts ? bm_t : bm2_t)
// * w_t; 0 where a live slot (w != 0) has blockmax <= 0. A radix select
// over the bounds' ordered bits finds the (C+1)-th largest value v in
// digits of 12, 10 and 10 bits (the digit most of a warp's lanes share
// is counted in a register and added once, so the histogram's counters
// are not contended), and once at most 512 bounds share the prefix they
// are gathered and ranked instead of counted further; the blocks above
// v and the lowest-id blocks equal to it are compacted in id order
// by two block-wide prefix counts, which keeps the pick stable (equal
// bounds go to the lowest ids, as lax.top_k keeps them) and leaves the C
// ids ascending; next_ub is the bound of the (C+1)-th. Bound: bytes, each
// slot's blockmax row (and blockmax2 and argpos, 9 B a block) read once.
//
// The full-scan mega phrase (wiser_tpu/engine/kernels.py _full_phrase_body
// :1648, make_full_phrase_kernel :1829, make_full_phrase_kernel_tc :1783;
// port engine/kernels.full_phrase_select and full_phrase_band) runs as
// three more instantiations of scan_kernel, under the phrase's rule: p =
// row * weight (tc: weight * the tf part from the tables), summed in slot
// order from 0, matched where every p > 0. The selection keeps the K =
// KV + 1 best lanes (1,025, or the rescue's 4,097), threshold first, in
// the plain version's own two-level order:
//   - kSweep streams every block of the query's rows through the ring and
//     pushes no key: each warp's 128 lanes are one block, whose largest
//     key (keys.cuh: score desc, doc asc, unique) two warp max-reductions
//     find and lane 0 writes to a (B, NB) row of block keys (0: no
//     matched lane). In tc a 4-lane word's tf bytes are tested for a
//     match first (tf > 0 on every term, one instruction a term), and
//     only a word with a matched lane reads the tables. Its segments
//     share nothing, so they are planned to whole waves with no merge;
//   - kSelect over a block list read from those keys (the listed
//     selection): each CTA copies its query's block keys into shared
//     memory, finds their K-th largest, kappa, by a radix select from
//     the first byte the matched blocks' keys differ in, ranking the
//     last 256 candidates outright (kth_block_key), and ranks the
//     blocks whose key is at or above it in id order (exactly K where
//     kappa > 0; every matched block where fewer than K match). Every
//     one of the K blocks holds a lane at or above kappa, so the
//     (KV+1)-th lane key is too, and no lane outside them reaches it:
//     the CTA streams its slice of those blocks (each thread copying its
//     own lanes) and pushes only keys at or above kappa;
//   - kSelect over every block (the one-pass selection), where the doc
//     space has fewer than K blocks (ops/dense.select_path).
// Either selection keeps the keys above its push threshold tau unsorted
// in one shared buffer of KP + 2 steps' keys; when fewer than a step's
// lanes are free, keep_top cuts it to its top K by the radix select and
// a compaction and raises tau to the K-th key. A query's segments (at
// most 8) are one thread-block cluster: they share their thresholds
// through the first CTA's word, each cuts its keys to K, and the first
// CTA streams the others' kept keys out of distributed shared memory
// through the same push and keep_top, so no second launch and no
// device-memory scratch is needed. The kept keys are sorted once,
// at the end, and written as (lane, f32 score) in (score desc, doc asc)
// order, lane -1 and score -inf past the matched lanes: the canonical
// top K, which the plain version's stable two-level selection keeps too,
// ties included (ops/dense.py says why);
//   - kBand: a query needs the band only where its (KV+1)-th score
//     reaches thr = kth * (1 - eps3), since no lane outside the
//     selection scores above it; every other query's CTAs return at
//     once. A needing query first tests that (KV+1)-th lane itself
//     (raw: it always flags then), else rescores lanes: a lane flags
//     where it matches, scores >= thr, ranks after the KV-th selected
//     key and, tc, its payload differs from the k-th kept doc's on some
//     term or its doc is below that doc's. With the sweep's block keys
//     (the listed band: tc, after the threshold-first selection; a raw
//     row that needs the band always flags at its (KV+1)-th lane) each
//     CTA lists, in id order, the blocks of its segment whose key is a
//     match scoring >= thr (band_blocks: one key a thread, a ballot a
//     warp) and streams only those, each thread copying its own lanes as
//     the listed selection does: a band lane's block key is at least its
//     own key, and the sweep's score of a lane is the band's bit for bit
//     (its table entry past kTft is the division the band makes on its
//     cache), so no other block holds one. Without them (raw, or the
//     one-pass selection, NB < K) it streams every block through the
//     ring. A CTA stops at its query's first hit, through the query's
//     word that it polls each step; the word is the output.
// Bound: bytes, the query's distinct rows read once for the selection
// (the sweep reads them; the listed selection reads K blocks of them
// again, and the block keys; the band reads nothing where no query needs
// it, and a needing query's block keys and its listed blocks' rows where
// none flags).
//
// Arithmetic: every f32 operation is an explicit round-to-nearest
// intrinsic and the library is built with -fmad=false, so scores and
// bounds equal the plain version's bit for bit. Offsets into the planes
// (row * N_pad + doc, row * NB + blk) and the outputs are 64-bit.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "keys.cuh"
#include "select.cuh"

namespace wiser_dense {

using namespace wiser_keys;
using namespace wiser_select;

// Phase marks for a measuring build (-DWISER_CLOCKS, clocks.cuh; never
// the library the entry points load): thread 0 of every CTA adds the
// cycles between marks to its phase's counter, read by wiser_dense_clocks.
#include "clocks.cuh"

constexpr int kThreads = 256;     // the scan's and the merge's CTA
constexpr int kLPT = 4;           // lanes a thread scores a step
constexpr int kMaxStepBlocks = 8;  // 1,024 lanes: kThreads * kLPT
constexpr int kMaxStages = 4;
// the raw scan's CTAs an SM its registers must allow: 4 by measurement
// (PERF.md §6; with no bound it took 92 registers, two CTAs an SM; 5 or
// 6 spill). The tc scan takes 48 registers with no bound.
constexpr int kRawMinBlocks = 4;
// tf bytes below this score from the shared norm table, 16 by
// measurement among 16, 32 and 64 (PERF.md §6; ops/dense.TC_TFT)
constexpr int kTft = 16;
// the bits of a word's 4 tf bytes that are set in a byte >= kTft
constexpr unsigned kTftHigh = (0xFFu ^ (kTft - 1)) * 0x01010101u;
// the running lists (R, R2) live in shared memory up to this KP, past it
// in a device scratch the wrapper allocates (a K = M + 1 of any size)
constexpr int kKeySmemCap = 4096;
constexpr int kMergeLanes = 1024;  // keys a merge step reads
constexpr int kIdsCap = 1024;      // a block list's ids a segment at most
constexpr int kFlushBytes = 1056;  // a flush's scratch (FlushSmem)
// scan_kernel's instantiations: the dense scan, the phrase's selection,
// its band pass and its block-key sweep
constexpr int kScan = 0, kSelect = 1, kBand = 2, kSweep = 3;
constexpr int kMaxCluster = 8;     // a selection's segments at most
// the listed selection copies its query's block keys into shared memory
// (over its ring and key buffer, before either is used) for the pick up
// to this many bytes, else reads them from device memory
constexpr long long kPickSmemCap = 160 * 1024;
constexpr int kBandMaxT = 128;     // the band's slots at most (BandSmem)
constexpr int kPickThreads = 512;  // the pick's CTA
constexpr int kPickWarps = kPickThreads / 32;
// the pick keeps its NB bounds in shared memory up to this many bytes
constexpr long long kUbSmemBytes = 200 * 1024;

struct ScanArgs {
  const float* sc;          // raw: (H, N_pad) f32 scores
  const int32_t* tf;        // raw: (H, N_pad) i32 tfs
  const uint8_t* tf8;       // tc: (H, N_pad) u8 tfs; null on raw planes
  const uint8_t* code;      // tc: (N_pad,) u8 len codes
  const float* avg32;       // tc: one f32
  float* norm_g;            // tc: (256, 256) f32, tc_norm_kernel's table
  const int32_t* slots;     // (B, T) rows
  const float* weights;     // (B, T) use_score (raw) or idf32 (tc)
  const long long* blocks;  // (B, nblk) ascending block ids; null: every block
  long long H, N_pad;
  int B, T, M, nblk, K, KP, nseg, bps;
  int NS, SB;  // ring stages, blocks a step
  unsigned long long* part_keys;  // (B, nseg, K) when nseg > 1
  unsigned long long* rscratch;   // (B, nseg, 2, KP) when KP > kKeySmemCap
  // the threshold-first selection: (B, NB) block keys, written by the
  // sweep and read by the listed selection (kSelect with bkeys set)
  unsigned long long* bkeys;
  int32_t* top_docs;  // (B, M); kSelect: (B, K) lanes
  float* top_score;   // (B, M); kSelect: (B, K) scores
  int32_t* top_tfs;   // (B, T, M)
  int32_t* flags;     // (B,)
  // kBand: a selection's (B, K) lanes and scores, (B,) thresholds and,
  // tc, the k-th kept docs; hit (B,) zeroed before the launch
  const int32_t* sel_lanes;
  const float* sel_score;
  const float* thr;
  const int32_t* kth_doc;
  int32_t* hit;
};

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) & ~15LL;
}

__host__ __device__ constexpr bool keys_in_smem(int KP) {
  return KP <= kKeySmemCap;
}

// The scan's shared memory, in order: kMaxStages mbarriers, the row
// count and, a split selection, its cluster's threshold word (48 B) | 3
// step counters | a flush's scratch | the query's
// distinct row offsets, each slot's row index and weight (T each) | a
// block list's segment ids (kIdsCap) | tc: the cache (256 f32) and norm
// (256 * kTft f32) tables | NS ring stages, each T row segments of SB *
// 128 lanes and, tc, the len-code segment | R and R2 (KP keys each, up
// to kKeySmemCap) and X (2 * SB * 128 keys); the selection (sel) keeps
// only X, of KP + 2 * SB * 128 keys (select_keys); the band keeps no keys
// (KP 0) and uses the flush's scratch for its words (BandSmem).
// ops/dense.scan_bytes computes the same.
struct ScanLayout {
  long long counters, fsm, off, ri, w, ids, cache, norm, ring, stage, lists,
      total;
};

__host__ __device__ inline ScanLayout scan_layout(bool tc, bool listed, int T,
                                                  int KP, int NS, int SB,
                                                  bool sel = false) {
  ScanLayout L;
  const long long SL = (long long)SB * 128;
  long long o = 48;
  L.counters = o;
  o += 16;
  L.fsm = o;
  o += kFlushBytes;
  L.off = o;
  o += align16(8LL * T);
  L.ri = o;
  o += align16(4LL * T);
  L.w = o;
  o += align16(4LL * T);
  L.ids = o;
  o += listed ? 8LL * kIdsCap : 0;
  L.cache = o;
  o += tc ? 1024 : 0;
  L.norm = o;
  o += tc ? 4LL * 256 * kTft : 0;
  L.ring = o;
  L.stage = align16(T * SL * (tc ? 1 : 4) + (tc ? SL : 0));
  o += NS * L.stage;
  L.lists = o;
  if (sel) {
    o += 8 * (KP + 2 * SL);
  } else {
    o += KP ? (keys_in_smem(KP) ? 16LL * KP : 0) + 16 * SL : 0;
  }
  L.total = o;
  return L;
}

// The merge's: 3 counters (16 B) | X (2 * kMergeLanes keys) | a flush's
// scratch | R and R2 (none past kKeySmemCap: then they are the first
// segment's scratch).
__host__ __device__ constexpr long long merge_bytes(int KP) {
  return 16 + 16LL * kMergeLanes + kFlushBytes +
         (keys_in_smem(KP) ? 16LL * KP : 0);
}

__device__ __forceinline__ long long clamp_row(int r, long long H) {
  return r < 0 ? 0 : (r >= H ? H - 1 : r);
}

// -- the ring's asynchronous copies --------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also expects `bytes` of copies to complete
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a 16-byte aligned run of `bytes` (a multiple of 16) from device memory
// into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 4 or 16 bytes from device memory into shared memory (a block list's
// lanes, each thread its own)
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// this thread's copies complete but for its newest n groups (n < 4)
__device__ __forceinline__ void copy_wait(int n) {
  if (n <= 1) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
  } else if (n == 2) {
    asm volatile("cp.async.wait_group 2;" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 3;" ::: "memory");
  }
}

// -- the scan ------------------------------------------------------------

// The tc table of every (tf byte, len code) in device memory,
// norm[tf * 256 + code] = tc_norm(tf, tc_cache(code, avg)) (255: the
// fixed bound): the scan's lanes with tf >= kTft read it (through L1),
// so no lane divides. Grid 256 (tf) x 256 threads (code), launched
// before the scan on its stream.
__global__ void __launch_bounds__(256) tc_norm_kernel(const float* avg32,
                                                      float* norm) {
  const int tf = blockIdx.x, code = threadIdx.x;
  norm[tf * 256 + code] = tc_norm(tf, tc_cache(code, *avg32));
}

// The outputs of query b from its descending keys (at least K readable,
// 0-padded): kSelect the K keys as (lane, score).
template <bool TC, int KIND>
__device__ void write_outputs(const ScanArgs& a, int b,
                              const unsigned long long* keys, int tid) {
  const int T = a.T, M = a.M;
  const float ninf = -__int_as_float(0x7f800000);
  if constexpr (KIND == kSelect) {
    for (int m = tid; m < a.K; m += kThreads) {
      const unsigned long long key = keys[m];
      const long long o = (long long)b * a.K + m;
      a.top_docs[o] = key ? tile_key_lane(key) : -1;
      a.top_score[o] = key ? tile_key_score(key) : ninf;
    }
    return;
  }
  bool sat = false;
  for (int m = tid; m < M; m += kThreads) {
    const unsigned long long key = keys[m];
    const long long o = (long long)b * M + m;
    const int doc = key ? tile_key_lane(key) : -1;
    a.top_score[o] = key ? tile_key_score(key) : ninf;
    a.top_docs[o] = doc;
    for (int t = 0; t < T; ++t) {
      int tf = 0;
      if (key) {
        const long long i =
            clamp_row(a.slots[(long long)b * T + t], a.H) * a.N_pad + doc;
        if (TC) {
          tf = a.tf8[i];
          sat = sat || tf >= kTfSat;
        } else {
          tf = a.tf[i];
        }
      }
      a.top_tfs[((long long)b * T + t) * M + m] = tf;
    }
  }
  const int any_sat = __syncthreads_or(sat);
  if (tid == 0) {
    int f = 0;
    const unsigned long long k0 = keys[M - 1], k1 = keys[M];
    if (k0 && k1 && tile_key_score(k1) == tile_key_score(k0)) f |= kFlagTrunc;
    if (any_sat) f |= kFlagTfSat;
    a.flags[b] = f;
  }
}

static_assert(sizeof(FlushSmem) <= kFlushBytes, "kFlushBytes");
static_assert(kSelThreads == kThreads && kSelLPT == kLPT,
              "select.cuh works on the scan's CTA and lanes");

// The band's words, in the flush's scratch (the band keeps no keys).
struct BandSmem {
  unsigned long long kvkey;  // the KV-th selected key: a lane flags below it
  float thr;
  int kd;                    // tc: the k-th kept doc
  unsigned code_k;           // tc: its len code, in each byte
  int stop;                  // the query is decided: hit set, or to set
  unsigned ktf[kBandMaxT];   // tc: its tf byte in each distinct row, in
                             // each byte
};
static_assert(sizeof(BandSmem) <= kFlushBytes, "kFlushBytes");
// the listed band's warp counts (band_blocks), in the flush's histogram
// past the band's words
constexpr int kBandCounts = 248;
static_assert(sizeof(BandSmem) <= 4 * kBandCounts &&
                  kBandCounts + kThreads / 32 <= 256,
              "the band's counts");

// The band's words of query b, by one thread, once the query's distinct
// rows (s_off, s_ri), weights and, tc, the cache table are in shared
// memory; then the (KV+1)-th lane alone is tested (it flags unless, tc,
// it is a payload tie of the k-th kept doc at a higher doc): stop where
// it flags or another CTA of the query has already flagged.
template <bool TC>
__device__ void band_setup(const ScanArgs& a, int b, int nr,
                           const long long* s_off, const int* s_ri,
                           const float* s_w, const float* s_cache,
                           BandSmem& bs) {
  const long long kb = (long long)b * a.K;
  const int kvl = a.sel_lanes[kb + a.K - 2];
  bs.kvkey = kvl >= 0 ? tile_key(a.sel_score[kb + a.K - 2], kvl) : 0ull;
  const float thr = a.thr[b];
  bs.thr = thr;
  int kd = 0;
  if (TC) {
    const int k = a.kth_doc[b];
    kd = k < 0 ? 0 : (k >= a.N_pad ? (int)a.N_pad - 1 : k);
    bs.kd = kd;
    bs.code_k = a.code[kd] * 0x01010101u;
    for (int j = 0; j < nr; ++j)
      bs.ktf[j] = a.tf8[s_off[j] + kd] * 0x01010101u;
  }
  bool hit = false;
  const int lane = a.sel_lanes[kb + a.K - 1];
  if (lane >= 0 && lane < a.N_pad) {
    bool match = true, bad = lane < kd;
    float acc = 0.f;
    const int code = TC ? a.code[lane] : 0;
    if (TC) bad = bad || (unsigned)code != (bs.code_k & 255u);
    for (int t = 0; t < a.T; ++t) {
      const long long i = s_off[s_ri[t]] + lane;
      float p;
      if (TC) {
        const int tf = a.tf8[i];
        p = __fmul_rn(s_w[t], tc_norm(tf, s_cache[code]));
        bad = bad || (unsigned)tf != (bs.ktf[s_ri[t]] & 255u);
      } else {
        p = __fmul_rn(a.sc[i], s_w[t]);
      }
      match = match && p > 0.f;
      acc = __fadd_rn(acc, p);
    }
    hit = match && acc >= thr && tile_key(acc, lane) < bs.kvkey &&
          (!TC || bad);
  }
  bs.stop = hit || *reinterpret_cast<volatile const int*>(a.hit + b);
}

// The c keys of X merged into the running list R (KP keys, the top K
// kept) through R2, which then swap. Where K <= kThreads and c > K only
// X's top K are needed: the K-th key found by kth_key, the K keys at or
// above it gathered into R2 (free until the merge writes it), ranked
// there and put back; else X is sorted whole (keys.cuh sort_keys).
__device__ void flush_keys(unsigned long long*& R, unsigned long long*& R2,
                           int KP, int K, unsigned long long* X, int c,
                           FlushSmem& f, int tid) {
  if (K <= kThreads && c > K) {
    const unsigned long long t = kth_key(X, c, K, f, tid);
    if (tid == 0) f.n = 0;
    __syncthreads();
    const unsigned lt = (1u << (tid & 31)) - 1;
    for (int i0 = 0; i0 < c; i0 += kThreads) {
      const int i = i0 + tid;
      const unsigned long long x = i < c ? X[i] : 0ull;
      const bool keep = i < c && x >= t;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      if (m) {
        int at = 0;
        if ((tid & 31) == __ffs(m) - 1) at = atomicAdd(&f.n, __popc(m));
        at = __shfl_sync(0xffffffffu, at, __ffs(m) - 1);
        if (keep) R2[at + __popc(m & lt)] = x;
      }
    }
    __syncthreads();
    sort_keys<kThreads>(R2, K, tid);
    for (int i = tid; i < K; i += kThreads) X[i] = R2[i];
    __syncthreads();
    c = K;
  } else {
    sort_keys<kThreads>(X, c, tid);
  }
  merge_ranks<kThreads, false>(R, nullptr, R2, nullptr, KP, X, nullptr,
                               min(c, K), 0u, tid);
  unsigned long long* r = R;
  R = R2;
  R2 = r;
}

// A phrase lane set's 4 lanes of this thread in a stage (kSweep,
// kSelect): match bit j where every slot's p > 0, acc[j] the f32 sum of
// the p in slot order from 0 (raw p = v * w; tc p = w * the tf part from
// the shared table below kTft, the device one past it). tc first tests
// the word's tf bytes: a lane whose byte is 0 in some slot has p 0 there,
// so a word with no lane nonzero in every slot reads no table.
template <bool TC>
__device__ __forceinline__ unsigned phrase_lanes(
    const unsigned char* stage, int lane, long long SL, long long code_at,
    int T, const int* s_ri, const float* s_w, const float* s_norm,
    const float* norm_g, float* acc) {
  unsigned match = (1u << kLPT) - 1;
  if (TC) {
    const unsigned cw = *reinterpret_cast<const unsigned*>(stage + code_at +
                                                           lane);
    unsigned nz = 0x80808080u;  // bit 7 of a lane's byte: tf > 0 so far
    for (int t = 0; t < T; ++t) {
      const unsigned qw = *reinterpret_cast<const unsigned*>(
          stage + (long long)s_ri[t] * SL + lane);
      nz &= ((qw & 0x7f7f7f7fu) + 0x7f7f7f7fu) | qw;
    }
    if (!nz) return 0u;
    for (int t = 0; t < T; ++t) {
      const unsigned qw = *reinterpret_cast<const unsigned*>(
          stage + (long long)s_ri[t] * SL + lane);
      const float w = s_w[t];
      // each lane's table index tf << 8 | code, two lanes' a byte permute
      // (tf 0 reads 0)
      const unsigned p01 = __byte_perm(cw, qw, 0x5140);
      const unsigned p23 = __byte_perm(cw, qw, 0x7362);
      const unsigned ix[kLPT] = {p01 & 0xffff, p01 >> 16, p23 & 0xffff,
                                 p23 >> 16};
      float norm[kLPT];
      if (!(qw & kTftHigh)) {  // every tf byte below kTft: the shared table
#pragma unroll
        for (int j = 0; j < kLPT; ++j) norm[j] = s_norm[ix[j]];
      } else {
#pragma unroll
        for (int j = 0; j < kLPT; ++j)
          norm[j] = ix[j] < kTft * 256 ? s_norm[ix[j]] : __ldg(norm_g + ix[j]);
      }
#pragma unroll
      for (int j = 0; j < kLPT; ++j) {
        const float p = __fmul_rn(w, norm[j]);
        if (!(p > 0.f)) match &= ~(1u << j);
        acc[j] = __fadd_rn(acc[j], p);
      }
    }
    return match;
  }
  for (int t = 0; t < T; ++t) {
    const float4 v4 = *reinterpret_cast<const float4*>(
        stage + ((long long)s_ri[t] * SL + lane) * 4);
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
    const float w = s_w[t];
#pragma unroll
    for (int j = 0; j < kLPT; ++j) {
      const float p = __fmul_rn(v[j], w);
      if (!(p > 0.f)) match &= ~(1u << j);
      acc[j] = __fadd_rn(acc[j], p);
    }
  }
  return match;
}

// The k-th largest (1 <= k <= n) of the n block keys X[0, n), by the CTA.
// Keys are unique but for 0 (a block with no match): where fewer than k
// are nonzero, 0. Else a first pass finds the high bits every nonzero
// key shares (their AND and OR), then select.cuh kth_key's radix select
// runs from the first byte they differ in (the digit most of a warp's
// lanes share counted once), until at most kThreads keys share the
// prefix found so far: those are gathered into G (kThreads keys of
// scratch) and ranked, a thread a key. Every thread calls it; it ends
// with a barrier.
__device__ unsigned long long kth_block_key(const unsigned long long* X,
                                            int n, int k, FlushSmem& f,
                                            unsigned long long* G, int tid) {
  const int wl = tid & 31;
  unsigned long long all_and = ~0ull, any_or = 0ull;
  int nz = 0;
  for (int i = tid; i < n; i += kThreads) {
    const unsigned long long x = X[i];
    if (x) {
      all_and &= x;
      any_or |= x;
      ++nz;
    }
  }
  if (tid == 0) {
    G[0] = ~0ull;
    G[1] = 0ull;
    f.n = 0;
  }
  __syncthreads();
  const unsigned a_hi = __reduce_and_sync(0xffffffffu, (unsigned)(all_and >> 32));
  const unsigned a_lo = __reduce_and_sync(0xffffffffu, (unsigned)all_and);
  const unsigned o_hi = __reduce_or_sync(0xffffffffu, (unsigned)(any_or >> 32));
  const unsigned o_lo = __reduce_or_sync(0xffffffffu, (unsigned)any_or);
  const unsigned nz_w = __reduce_add_sync(0xffffffffu, (unsigned)nz);
  if (wl == 0) {
    atomicAnd(G, (unsigned long long)a_hi << 32 | a_lo);
    atomicOr(G + 1, (unsigned long long)o_hi << 32 | o_lo);
    atomicAdd(&f.n, nz_w);
  }
  __syncthreads();
  const unsigned long long common = G[0], diff = G[0] ^ G[1];
  const unsigned n_nz = f.n;
  __syncthreads();  // every thread has read G and f
  if (n_nz < (unsigned)k) return 0ull;
  if (!diff) return common;  // one nonzero key
  // the radix select from the byte of the highest differing bit
  const int start = ((63 - __clzll((long long)diff)) >> 3) << 3;
  unsigned long long prefix = start == 56 ? 0ull : common & (~0ull << (start + 8));
  unsigned rem = k;
  for (int shift = start;; shift -= 8) {
    for (int i = tid; i < 256; i += kThreads) f.hist[i] = 0;
    __syncthreads();
    const unsigned long long hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const unsigned long long x = i < n ? X[i] : 0ull;
      const bool in = i < n && (x & hi) == prefix;
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
    const unsigned count = f.count;
    if (shift == 0 && count > 1) {  // equal keys: only zeros can be
      __syncthreads();  // every thread has read f
      return prefix;
    }
    if (count > kThreads) continue;
    // few keys share the prefix: gather and rank them
    const unsigned long long mask = ~0ull << shift;
    __syncthreads();  // every thread has read f
    if (tid == 0) f.n = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += kThreads) {
      const int i = i0 + tid;
      const unsigned long long x = i < n ? X[i] : 0ull;
      const bool in = i < n && (x & mask) == prefix;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (m) {
        int at = 0;
        if (wl == __ffs(m) - 1) at = atomicAdd(&f.n, __popc(m));
        at = __shfl_sync(0xffffffffu, at, __ffs(m) - 1);
        if (in) G[at + __popc(m & ((1u << wl) - 1))] = x;
      }
    }
    __syncthreads();
    if (tid < (int)count) {
      const unsigned long long x = G[tid];
      unsigned above = 0;
      for (unsigned j = 0; j < count; ++j) above += G[j] > x;
      if (above == rem - 1) f.key = x;
    }
    __syncthreads();
    const unsigned long long key = f.key;
    __syncthreads();  // every thread has read f
    return key;
  }
}

// The bytes the listed selection's pick keeps in shared memory: its
// query's NB block keys, or 0 where they are read from device memory.
__host__ __device__ constexpr long long pick_smem(long long NB) {
  return 8 * NB <= kPickSmemCap ? 8 * NB : 0;
}

// The listed selection's blocks of query b: kappa, the K-th largest of
// its NB block keys (the sweep's; copied to `keys` first, shared memory
// free until the ring fills, where pick_smem allows), then the blocks
// whose key is at or above max(kappa, 1) ranked in id order, those of
// ranks [lo, lo + bps) into s_ids. Returns the end of this segment's
// ranks (at most lo + bps; at or below lo where the query has fewer) and
// sets tau0 to the push threshold, kappa's predecessor. Every thread
// calls it; it ends with a barrier.
__device__ int listed_blocks(const ScanArgs& a, int b, int lo, long long* s_ids,
                             unsigned long long* keys, FlushSmem& fs,
                             unsigned long long& tau0, int tid) {
  constexpr int kUnroll = 8;  // loads in flight a thread while copying
#ifdef WISER_CLOCKS
  // a measuring build's split of the pick: the copy (26), the K-th key
  // (27), the ranks (28)
  long long pick_t = clock64();
  auto mark = [&](int i) {
    if (tid == 0) {
      const long long now = clock64();
      atomicAdd(&g_clk[i], (unsigned long long)(now - pick_t));
      pick_t = now;
    }
  };
#else
  auto mark = [](int) {};
#endif
  const long long NB = a.N_pad >> 7;
  const unsigned long long* bk = a.bkeys + (long long)b * NB;
  if (pick_smem(NB)) {
    for (long long i0 = tid; i0 < NB; i0 += kUnroll * kThreads) {
      unsigned long long v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = i0 + (long long)j * kThreads;
        v[j] = i < NB ? __ldcg(bk + i) : 0ull;
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        const long long i = i0 + (long long)j * kThreads;
        if (i < NB) keys[i] = v[j];
      }
    }
    __syncthreads();
    bk = keys;
  }
  mark(26);
  // s_ids is free until the ranks below fill it: the ranking's scratch
  const unsigned long long kap0 = kth_block_key(
      bk, (int)NB, a.K, fs, reinterpret_cast<unsigned long long*>(s_ids),
      tid);
  mark(27);
  const unsigned long long kap = kap0 ? kap0 : 1ull;
  tau0 = kap - 1;
  // each thread a run of consecutive ids: its blocks at or above kap
  // counted, one exclusive scan over the CTA, then written in id order
  const long long span = (NB + kThreads - 1) / kThreads;
  const long long clo = min(NB, tid * span), chi = min(NB, clo + span);
  int n_in = 0;
  for (long long i = clo; i < chi; ++i) n_in += bk[i] >= kap;
  const int wl = tid & 31, w = tid >> 5;
  int x = n_in;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (wl >= off) x += y;
  }
  if (wl == 31) fs.hist[w] = x;  // each warp's total
  __syncthreads();
  int r = x - n_in, total = 0;
  for (int v = 0; v < kThreads / 32; ++v) {
    const int c = fs.hist[v];
    r += v < w ? c : 0;
    total += c;
  }
  for (long long i = clo; i < chi && r < lo + a.bps; ++i) {
    if (bk[i] < kap) continue;
    if (r >= lo) s_ids[r - lo] = i;
    ++r;
  }
  __syncthreads();
  mark(28);
  return min(total, lo + a.bps);
}

// The listed band's blocks of query b in this segment's id range [lo,
// hi) (at most kIdsCap): those whose sweep key (a.bkeys) is a match that
// scores at or above thr, in id order, into s_ids. A lane of the band
// matches and scores at or above thr, and its block's key is its block's
// largest lane key, whose score is the same f32 as the band's score of
// that lane (the sweep's table entry past kTft and the band's division
// are the same operations on the same inputs), so no other block holds
// one. Returns their count. Every thread calls it, once band_setup has
// found the query undecided; it ends with a barrier. wc: 8 words of
// scratch (past the band's words).
__device__ int band_blocks(const ScanArgs& a, int b, int lo, int hi,
                           long long* s_ids, unsigned* wc, int tid) {
  const long long NB = a.N_pad >> 7;
  const unsigned long long* bk = a.bkeys + (long long)b * NB;
  const float thr = a.thr[b];
  const int wl = tid & 31, w = tid >> 5;
  int total = 0;
  for (int i0 = lo; i0 < hi; i0 += kThreads) {
    const int i = i0 + tid;
    const unsigned long long k = i < hi ? __ldcg(bk + i) : 0ull;
    const bool in = k != 0ull && tile_key_score(k) >= thr;
    const unsigned m = __ballot_sync(0xffffffffu, in);
    if (wl == 0) wc[w] = __popc(m);
    __syncthreads();
    int at = total, all = 0;
    for (int v = 0; v < kThreads / 32; ++v) {
      const int c = wc[v];
      at += v < w ? c : 0;
      all += c;
    }
    if (in) s_ids[at + __popc(m & ((1u << wl) - 1))] = i;
    total += all;
    __syncthreads();  // every thread has read the counts
  }
  return total;
}

// A split selection's merge: the c kept keys of each CTA of the cluster
// (X[0, c), c <= K, unsorted) streamed by the cluster's first CTA out of
// distributed shared memory through its push threshold and keep_top,
// SL keys a round. Returns the first CTA's kept count (the others' return
// value is unused: they leave once every CTA has passed the last cluster
// barrier). Every thread of every CTA of the cluster calls it.
__device__ int merge_cluster(unsigned long long* X, int c, int K, int SL,
                             int xcap, FlushSmem& fs, int* cnt, int seg,
                             int nseg, int tid) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (tid < 3) cnt[tid] = 0;
  if (tid == 0) cnt[3] = c;
  cluster.sync();  // every CTA's keys and count are whole
  if (seg == 0) {
    int base = c, step = 0;
    for (int r = 1; r < nseg; ++r) {
      const unsigned long long* P = cluster.map_shared_rank(X, r);
      const int pc = *cluster.map_shared_rank(cnt + 3, r);
      for (int i0 = 0; i0 < pc; i0 += SL, ++step) {
        unsigned long long key[kLPT];
#pragma unroll
        for (int j = 0; j < kLPT; ++j) {
          const int i = i0 + tid * kLPT + j;
          key[j] = tid * kLPT + j < SL && i < pc ? P[i] : 0ull;
        }
        push_keys(key, fs.tau, X, base, cnt + step % 3);
        __syncthreads();
        const int n = base + cnt[step % 3];
        if (tid == 0) cnt[(step + 2) % 3] = 0;
        if (n > xcap - SL) {
          const unsigned long long t = keep_top(X, n, K, fs, tid);
          if (tid == 0) fs.tau = t;
          __syncthreads();
          base = K;
        } else {
          base = n;
        }
      }
    }
    c = base;
  }
  cluster.sync();  // the first CTA has read every other's keys
  return c;
}

// One (segment, query) pair a CTA: grid (nseg, B). KIND: kScan the dense
// scan, kSelect the phrase's selection, kBand its band pass, kSweep its
// block-key sweep.
template <bool TC, int KIND>
__global__ void __launch_bounds__(kThreads, TC ? 1 : kRawMinBlocks)
    scan_kernel(ScanArgs a) {
  constexpr int LB = TC ? 1 : 4;  // bytes a lane
  constexpr bool kPhrase = KIND != kScan;
  // a measuring build's counters: the sweep's phases apart from the
  // others' (clocks.cuh)
  constexpr int kClk = KIND == kSweep ? 16 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int seg = blockIdx.x, b = blockIdx.y;
  const int T = a.T, KP = a.KP, K = a.K;
  if constexpr (KIND == kBand) {
    // no lane outside the selection scores above its (KV+1)-th: where
    // that score is below thr (or -inf), the band is empty
    if (!(a.sel_score[(long long)b * K + K - 1] >= a.thr[b])) return;
  }
  const int SB = a.SB, SL = SB * 128, NS = a.NS;
  const ScanLayout L = scan_layout(
      TC,
      KIND == kSelect || KIND == kBand ? a.bkeys != nullptr
                                       : a.blocks != nullptr,
      T, KP, NS, SB, KIND == kSelect);
  WCLK_START
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* s_nrows = reinterpret_cast<int*>(smem + 32);
  int* cnt = reinterpret_cast<int*>(smem + L.counters);
  FlushSmem& fs = *reinterpret_cast<FlushSmem*>(smem + L.fsm);
  long long* s_ids = reinterpret_cast<long long*>(smem + L.ids);
  long long* s_off = reinterpret_cast<long long*>(smem + L.off);
  int* s_ri = reinterpret_cast<int*>(smem + L.ri);
  float* s_w = reinterpret_cast<float*>(smem + L.w);
  float* s_cache = reinterpret_cast<float*>(smem + L.cache);
  float* s_norm = reinterpret_cast<float*>(smem + L.norm);
  unsigned char* const ring = smem + L.ring;
  if (tid == 0) {
    // the query's distinct rows, in slot order (a padded slot repeats
    // slot 0's row): each is copied once a step
    int nr = 0;
    for (int t = 0; t < T; ++t) {
      const long long off =
          clamp_row(a.slots[(long long)b * T + t], a.H) * a.N_pad;
      int j = 0;
      while (j < nr && s_off[j] != off) ++j;
      if (j == nr) s_off[nr++] = off;
      s_ri[t] = j;
    }
    *s_nrows = nr;
    for (int s = 0; s < NS; ++s) mbar_init(bar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const long long NB = a.N_pad >> 7;
  const int blk_lo = seg * a.bps;
  int blk_hi = min(a.nblk, blk_lo + a.bps);
  // the listed selection: this segment's blocks of the query's K best,
  // and the push threshold below the K-th best block key
  unsigned long long tau0 = 0;
  if constexpr (KIND == kSelect) {
    if (a.bkeys)
      blk_hi = max(blk_lo, listed_blocks(
          a, b, blk_lo, s_ids,
          reinterpret_cast<unsigned long long*>(smem + L.ring), fs, tau0,
          tid));
    WCLK(24);
  }
  int nsteps = (blk_hi - blk_lo + SB - 1) / SB;
  // the pruned scan's block list: this segment's ids
  if (a.blocks) {
    const long long* blocks = a.blocks + (long long)b * a.nblk;
    for (int i = blk_lo + tid; i < blk_hi; i += kThreads) {
      const long long blk = blocks[i];
      s_ids[i - blk_lo] = blk < 0 ? 0 : (blk >= NB ? NB - 1 : blk);
    }
  }
  for (int t = tid; t < T; t += kThreads)
    s_w[t] = a.weights[(long long)b * T + t];
  if (tid < 3) cnt[tid] = 0;
  unsigned char* const lst = smem + L.lists;
  unsigned long long* R =
      a.rscratch ? a.rscratch + ((long long)b * a.nseg + seg) * 2 * KP
                 : reinterpret_cast<unsigned long long*>(lst);
  unsigned long long* R2 = R + KP;
  // the selection keeps X alone: the keys above tau, unsorted, cut to
  // their top K (keep_top) when fewer than a step's lanes are free
  unsigned long long* const X =
      a.rscratch || KIND == kSelect
          ? reinterpret_cast<unsigned long long*>(lst)
          : R2 + KP;
  const int xcap = KP + 2 * SL;
  volatile unsigned long long* const tau = &fs.tau;
  if (KIND == kScan) {
    for (int i = tid; i < KP; i += kThreads) R[i] = 0ull;
  } else if (KIND == kSelect && tid == 0) {
    *tau = tau0;
  }
  // a split selection's segments share their thresholds through the
  // cluster's first CTA's word (the header's spare 8 bytes): each
  // publishes its K-th key there when it cuts its keys (atomicMax) and
  // thread 0 reads it each step; every one is below the query's K-th
  // key, so the highest serves every segment
  unsigned long long* lead_tau = nullptr;
  if constexpr (KIND == kSelect) {
    if (a.nseg > 1) {
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      unsigned long long* own_word =
          reinterpret_cast<unsigned long long*>(smem + 40);
      if (tid == 0) *own_word = 0ull;
      lead_tau = cluster.map_shared_rank(own_word, 0);
      cluster.sync();  // the first CTA's word is zeroed
    }
  }
  if (TC) {
    tc_fill_tables<kThreads>(s_cache, s_norm, kTft, *a.avg32, tid);
  } else {
    __syncthreads();
  }
  const int nr = *s_nrows;
  BandSmem& bs = *reinterpret_cast<BandSmem*>(smem + L.fsm);
  if constexpr (KIND == kBand) {
    if (tid == 0) band_setup<TC>(a, b, nr, s_off, s_ri, s_w, s_cache, bs);
    __syncthreads();
    if (bs.stop) {
      if (tid == 0) a.hit[b] = 1;
      return;
    }
    // the listed band (tc), where the query goes on to stream: this
    // segment's blocks whose sweep key reaches thr
    if (a.bkeys) {
      blk_hi = blk_lo + band_blocks(a, b, blk_lo, blk_hi, s_ids,
                                    fs.hist + kBandCounts, tid);
      nsteps = (blk_hi - blk_lo + SB - 1) / SB;
    }
  }
  const unsigned char* plane =
      TC ? a.tf8 : reinterpret_cast<const unsigned char*>(a.sc);
  const long long code_at = (long long)T * SL;  // tc: in a stage
  const int nrc = nr + (TC ? 1 : 0);  // rows copied a step
  const int warp = tid >> 5, wl = tid & 31;

  const int lane = tid * kLPT;  // this thread's first lane in a step
  const int sub = lane >> 7, lane0 = lane & 127;
  // a block list: every thread copies its own lanes of each row (and of
  // the len codes) of step s into its stage, one commit group a step;
  // no other thread reads them, so its own wait is enough
  const bool own = KIND == kSelect || KIND == kBand ? a.bkeys != nullptr
                                                    : a.blocks != nullptr;
  auto issue_own = [&](int s) {
    const int s0 = blk_lo + s * SB;
    if (s < nsteps && lane < min(SB, blk_hi - s0) * 128) {
      unsigned char* stage = ring + (s % NS) * L.stage;
      const long long doc = s_ids[s0 - blk_lo + sub] * 128 + lane0;
      for (int j = 0; j < nr; ++j) {
        unsigned char* dst = stage + ((long long)j * SL + lane) * LB;
        const unsigned char* src = plane + (s_off[j] + doc) * LB;
        if (TC) {
          copy4(dst, src);
        } else {
          copy16(dst, src);
        }
      }
      if (TC) copy4(stage + code_at + lane, a.code + doc);
    }
    copy_commit();
  };
  // warp 0, every block: step s's row segments into its stage, a copy a
  // row segment, completing on the stage's mbarrier
  auto issue = [&](int s) {
    const int st = s % NS;
    const int s0 = blk_lo + s * SB, nb = min(SB, blk_hi - s0);
    unsigned char* stage = ring + st * L.stage;
    if (wl == 0)
      mbar_expect(bar + st, (unsigned)(nb * 128 * LB * nr +
                                       (TC ? nb * 128 : 0)));
    __syncwarp();
    for (int j = wl; j < nrc; j += 32) {
      const bool code = TC && j == nr;
      const unsigned char* src =
          code ? a.code + (long long)s0 * 128
               : plane + (s_off[j] + (long long)s0 * 128) * LB;
      bulk_copy(stage + (code ? code_at : (long long)j * SL * LB), src,
                (unsigned)(nb * 128 * (code ? 1 : LB)), bar + st);
    }
  };
  if (own) {
    for (int s = 0; s < NS - 1; ++s) issue_own(s);
  } else if (warp == 0) {
    for (int s = 0; s < min(NS, nsteps); ++s) issue(s);
  }
  WCLK(kClk + 0);

  int base = 0;  // keys in X before this step
  for (int s = 0; s < nsteps; ++s) {
    const int s0 = blk_lo + s * SB;
    const bool active = lane < min(SB, blk_hi - s0) * 128;
    long long doc0 = 0;
    if (active)
      doc0 = ((KIND == kSelect || KIND == kBand ? own : a.blocks != nullptr)
                  ? s_ids[s0 - blk_lo + sub]
                  : (long long)s0 + sub) *
                 128 + lane0;
    // the band: another CTA's hit on this query, read before the wait
    int polled = 0;
    if (KIND == kBand && tid == 0)
      polled = *reinterpret_cast<volatile const int*>(a.hit + b);
    // the split selection: the cluster's highest K-th key so far
    unsigned long long gpoll = 0;
    if (KIND == kSelect && lead_tau && tid == 0)
      gpoll = *reinterpret_cast<volatile const unsigned long long*>(lead_tau);
    if (own) {
      // the stage of step s - 1 is this thread's to refill
      issue_own(s + NS - 1);
      copy_wait(NS - 1);
    } else {
      mbar_wait(bar + s % NS, (unsigned)((s / NS) & 1));
    }
    WCLK(kClk + 1);
    const unsigned char* stage = ring + (s % NS) * L.stage;
    unsigned match = 0;
    unsigned dif = 0;  // the band, tc: a lane's byte nonzero where its
                       // payload differs from the k-th kept doc's
    float acc[kLPT];
#pragma unroll
    for (int j = 0; j < kLPT; ++j) acc[j] = 0.f;
    if constexpr (KIND == kSweep || KIND == kSelect) {
      if (active)
        match = phrase_lanes<TC>(stage, lane, SL, code_at, T, s_ri, s_w,
                                 s_norm, a.norm_g, acc);
    } else if (active) {
      match = (1u << kLPT) - 1;
      unsigned cw = 0;  // tc: the 4 lanes' len codes
      if (TC) cw = *reinterpret_cast<const unsigned*>(stage + code_at + lane);
      if (KIND == kBand && TC) dif = cw ^ bs.code_k;
      unsigned nz = 0x80808080u;  // tc: bit 7 of a lane's byte: tf > 0
      for (int t = 0; t < T; ++t) {
        const long long at = (long long)s_ri[t] * SL + lane;
        const float w = s_w[t];
        if (TC) {
          const unsigned qw = *reinterpret_cast<const unsigned*>(stage + at);
          if (!kPhrase) nz &= ((qw & 0x7f7f7f7fu) + 0x7f7f7f7fu) | qw;
          if (KIND == kBand) dif |= qw ^ bs.ktf[s_ri[t]];
          // each lane's table index tf << 8 | code, two lanes' a byte
          // permute (tf 0 reads 0): the shared table below kTft, the
          // device one (every tf byte) past it (the band: the division
          // it holds, on the shared cache)
          const unsigned p01 = __byte_perm(cw, qw, 0x5140);
          const unsigned p23 = __byte_perm(cw, qw, 0x7362);
          const unsigned ix[kLPT] = {p01 & 0xffff, p01 >> 16, p23 & 0xffff,
                                     p23 >> 16};
          float norm[kLPT];
          if (!(qw & kTftHigh)) {
#pragma unroll
            for (int j = 0; j < kLPT; ++j) norm[j] = s_norm[ix[j]];
          } else {
#pragma unroll
            for (int j = 0; j < kLPT; ++j)
              norm[j] = ix[j] < kTft * 256
                            ? s_norm[ix[j]]
                            : (KIND == kBand
                                   ? tc_norm(ix[j] >> 8, s_cache[ix[j] & 255])
                                   : __ldg(a.norm_g + ix[j]));
          }
#pragma unroll
          for (int j = 0; j < kLPT; ++j) {
            const float p = __fmul_rn(w, norm[j]);
            if (kPhrase && !(p > 0.f)) match &= ~(1u << j);
            acc[j] = __fadd_rn(acc[j], p);
          }
        } else {
          const float4 v4 = *reinterpret_cast<const float4*>(stage + at * 4);
          const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
          for (int j = 0; j < kLPT; ++j) {
            const float p = __fmul_rn(v[j], w);
            if (!((kPhrase ? p : v[j]) > 0.f)) match &= ~(1u << j);
            acc[j] = __fadd_rn(acc[j], p);
          }
        }
      }
      if (TC && !kPhrase)
        match = (nz >> 7 & 1) | (nz >> 14 & 2) | (nz >> 21 & 4) |
                (nz >> 28 & 8);
    }
    if constexpr (KIND == kSweep) {
      // the block's largest key: a warp's 128 lanes are one block (its
      // score bits first, then the lowest lane among its lanes that have
      // them); lane 0 writes it, 0 where no lane matched
      unsigned long long best = 0;
#pragma unroll
      for (int j = 0; j < kLPT; ++j)
        if (match >> j & 1) {
          const unsigned long long k = tile_key(acc[j], (int)(doc0 + j));
          best = k > best ? k : best;
        }
      const unsigned hi = __reduce_max_sync(0xffffffffu,
                                            (unsigned)(best >> 32));
      const unsigned lo = __reduce_max_sync(
          0xffffffffu, (unsigned)(best >> 32) == hi ? (unsigned)best : 0u);
      if (active && wl == 0)
        a.bkeys[(long long)b * NB + s0 + sub] =
            hi ? (unsigned long long)hi << 32 | lo : 0ull;
      WCLK(kClk + 2);
      // every thread has read this stage: warp 0 refills it
      __syncthreads();
      if (warp == 0 && s + NS < nsteps) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue(s + NS);
      }
      WCLK(kClk + 3);
      continue;
    }
    if constexpr (KIND == kBand) {
      // a lane of the band: matched, at or above thr, ranked after the
      // KV-th selected key and, tc, no payload tie above the k-th doc
      bool flag = false;
#pragma unroll
      for (int j = 0; j < kLPT; ++j) {
        const int doc = (int)(doc0 + j);
        flag = flag || ((match >> j & 1) && acc[j] >= bs.thr &&
                        tile_key(acc[j], doc) < bs.kvkey &&
                        (!TC || ((dif >> (8 * j)) & 255u) || doc < bs.kd));
      }
      WCLK(kClk + 2);
      // the step's barrier: every thread has read this stage
      if (__syncthreads_or(flag || polled)) {
        if (tid == 0) a.hit[b] = 1;
        // the copies still in flight land before the CTA leaves
        if (own) {
          asm volatile("cp.async.wait_all;" ::: "memory");
        } else {
          for (int s2 = s + 1; s2 < min(s + NS, nsteps); ++s2)
            mbar_wait(bar + s2 % NS, (unsigned)((s2 / NS) & 1));
        }
        return;
      }
      if (!own && warp == 0 && s + NS < nsteps) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        issue(s + NS);
      }
      WCLK(kClk + 3);
      continue;
    }
    // the matched keys above the running K-th, compacted into X after
    // the keys of earlier steps; R changes only between barriers
    unsigned long long key[kLPT];
#pragma unroll
    for (int j = 0; j < kLPT; ++j)
      key[j] = match >> j & 1 ? tile_key(acc[j], (int)(doc0 + j)) : 0ull;
    push_keys(key, KIND == kSelect ? *tau : R[K - 1], X, base, cnt + s % 3);
    WCLK(kClk + 2);
    // every thread has read this stage and counted its keys: warp 0
    // refills it
    __syncthreads();
    if (!own && warp == 0 && s + NS < nsteps) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(s + NS);
    }
    WCLK(kClk + 3);
    // this step's counter is read by every thread before the next
    // barrier; the one two steps on was last read before this barrier
    const int c = base + cnt[s % 3];
    if (tid == 0) cnt[(s + 2) % 3] = 0;
    if constexpr (KIND == kSelect) {
      // a threshold read late or early is still below the query's K-th
      // key: either keeps every key of its top K
      if (tid == 0 && gpoll > *tau) *tau = gpoll;
      if (c > xcap - SL) {
        const unsigned long long t = keep_top(X, c, K, fs, tid);
        if (tid == 0) {
          const unsigned long long g = lead_tau ? atomicMax(lead_tau, t) : 0;
          const unsigned long long nt = g > t ? g : t;
          if (nt > *tau) *tau = nt;
        }
        __syncthreads();
        WCLK_COUNT(kClk + 7);
        base = K;
      } else {
        base = c;
      }
      WCLK(kClk + 4);
      continue;
    }
    if (c >= SL) {
      flush_keys(R, R2, KP, K, X, c, fs, tid);
      WCLK_COUNT(kClk + 7);
      base = 0;
    } else {
      base = c;
    }
    WCLK(kClk + 4);
  }
  if constexpr (KIND == kScan) {
    if (base) flush_keys(R, R2, KP, K, X, base, fs, tid);
    __syncthreads();
    if (a.nseg == 1) {
      write_outputs<TC, KIND>(a, b, R, tid);
    } else {
      const long long o = ((long long)b * a.nseg + seg) * K;
      for (int i = tid; i < K; i += kThreads) a.part_keys[o + i] = R[i];
    }
  } else if constexpr (KIND == kSelect) {
    __syncthreads();
    int c = base;
    if (c > K) {
      keep_top(X, c, K, fs, tid);
      c = K;
    }
    // a split query: its cluster's keys into the first CTA
    if (a.nseg > 1) {
      c = merge_cluster(X, c, K, SL, xcap, fs, cnt, seg, a.nseg, tid);
      WCLK(25);
      if (seg != 0) {
        WCLK_COUNT(kClk + 6);
        return;
      }
      if (c > K) {
        keep_top(X, c, K, fs, tid);
        c = K;
      }
    }
    sort_kept(X, c, K, tid);
    write_outputs<TC, KIND>(a, b, X, tid);
  }
  WCLK(kClk + 5);
  WCLK_COUNT(kClk + 6);
}

// The second launch where a query's blocks span nseg segments: one CTA a
// query starts its running list from the first segment's K keys and
// streams the other segments' keys through the same threshold,
// compaction and merge as the scan, then writes the outputs.
template <bool TC>
__global__ void __launch_bounds__(kThreads) merge_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = a.KP, K = a.K;
  const int b = blockIdx.x, tid = threadIdx.x;
  int* cnt = reinterpret_cast<int*>(smem);
  unsigned long long* X = reinterpret_cast<unsigned long long*>(smem + 16);
  FlushSmem& fs =
      *reinterpret_cast<FlushSmem*>(smem + 16 + 16LL * kMergeLanes);
  // past kKeySmemCap: R and R2 in the first segment's scratch (its scan
  // is done)
  unsigned long long* R =
      a.rscratch ? a.rscratch + (long long)b * a.nseg * 2 * KP
                 : reinterpret_cast<unsigned long long*>(
                       smem + 16 + 16LL * kMergeLanes + kFlushBytes);
  unsigned long long* R2 = R + KP;
  const unsigned long long* part = a.part_keys + (long long)b * a.nseg * K;
  for (int i = tid; i < KP; i += kThreads) R[i] = i < K ? part[i] : 0ull;
  if (tid < 3) cnt[tid] = 0;
  __syncthreads();
  const long long n = (long long)(a.nseg - 1) * K;  // the other keys
  int base = 0, step = 0;
  for (long long i0 = 0; i0 < n; i0 += kMergeLanes, ++step) {
    unsigned long long key[kLPT];
#pragma unroll
    for (int j = 0; j < kLPT; ++j) {
      const long long i = i0 + tid * kLPT + j;
      key[j] = i < n ? part[K + i] : 0ull;
    }
    push_keys(key, R[K - 1], X, base, cnt + step % 3);
    __syncthreads();
    const int c = base + cnt[step % 3];
    if (tid == 0) cnt[(step + 2) % 3] = 0;
    if (c >= kMergeLanes) {
      flush_keys(R, R2, KP, K, X, c, fs, tid);
      base = 0;
    } else {
      base = c;
    }
  }
  if (base) flush_keys(R, R2, KP, K, X, base, fs, tid);
  __syncthreads();
  write_outputs<TC, kScan>(a, b, R, tid);
}

// -- the pick ------------------------------------------------------------

struct PickArgs {
  const float* bm;    // (H, NB) block maxima
  const float* bm2;   // (H, NB) second maxima, or null: the plain sum
  const uint8_t* ap;  // (H, NB) argmax lanes
  const int32_t* slots;   // (B, T)
  const float* weights;   // (B, T) the bound's multipliers
  long long H, NB;
  int B, T, C, nsplit, ub_smem;
  float* ub_scratch;  // (B, NB) when the bounds leave shared memory or
                      // nsplit > 1
  unsigned* done;     // (B,) zeroed words when nsplit > 1
  long long* blk;     // (B, C)
  float* next_ub;     // (B,)
};

__host__ __device__ constexpr long long pick_bytes(int T, long long NB,
                                                   bool ub_smem) {
  return align16(8LL * T) + align16(4LL * T) + (ub_smem ? 4 * NB : 0);
}

// a bound's order as an unsigned integer (-0 read as +0)
__device__ __forceinline__ unsigned order_bits(float f) {
  const unsigned u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Block k's joint bound. NT > 0 (T = NT, 1..8): each slot's bm,
// bm2 and ap loaded once into registers, the anchor loop reading them
// there; NT = 0: any T, loaded where used. The arithmetic is the same.
template <int NT>
__device__ __forceinline__ float block_bound(const PickArgs& a,
                                             const long long* s_off,
                                             const float* s_w, long long k) {
  const float ninf = -__int_as_float(0x7f800000);
  bool feas = true;
  float ub;
  if (NT > 0) {
    float x[NT > 0 ? NT : 1], x2[NT > 0 ? NT : 1];
    unsigned p[NT > 0 ? NT : 1];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      x[t] = a.bm[s_off[t] + k];
      feas = feas && (x[t] > 0.f || s_w[t] == 0.f);
      x2[t] = a.bm2 ? a.bm2[s_off[t] + k] : 0.f;
      p[t] = a.bm2 ? a.ap[s_off[t] + k] : 0u;
    }
    if (!a.bm2) {
      ub = __fmul_rn(x[0], s_w[0]);
#pragma unroll
      for (int t = 1; t < NT; ++t) ub = __fadd_rn(ub, __fmul_rn(x[t], s_w[t]));
    } else {
      ub = ninf;
#pragma unroll
      for (int ts = 0; ts < NT; ++ts) {
        float bound = __fmul_rn(x[ts], s_w[ts]);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          if (t == ts) continue;
          bound = __fadd_rn(bound, __fmul_rn(p[t] == p[ts] ? x[t] : x2[t],
                                             s_w[t]));
        }
        if (bound > ub) ub = bound;
      }
    }
  } else {
    const int T = a.T;
    ub = 0.f;
    for (int t = 0; t < T; ++t) {
      const float x = a.bm[s_off[t] + k];
      const float w = s_w[t];
      feas = feas && (x > 0.f || w == 0.f);
      if (!a.bm2) {
        const float p = __fmul_rn(x, w);
        ub = t == 0 ? p : __fadd_rn(ub, p);
      }
    }
    if (a.bm2) {
      ub = ninf;
      for (int ts = 0; ts < T; ++ts) {
        const uint8_t ap_s = a.ap[s_off[ts] + k];
        float bound = __fmul_rn(a.bm[s_off[ts] + k], s_w[ts]);
        for (int t = 0; t < T; ++t) {
          if (t == ts) continue;
          const long long i = s_off[t] + k;
          const float x = a.ap[i] == ap_s ? a.bm[i] : a.bm2[i];
          bound = __fadd_rn(bound, __fmul_rn(x, s_w[t]));
        }
        if (bound > ub) ub = bound;
      }
    }
  }
  return feas ? ub : 0.f;
}

// The exclusive prefix sum of v over the CTA (every thread calls it).
__device__ int cta_exclusive_scan(int v, int* s_warp) {
  const int tid = threadIdx.x, l = tid & 31, w = tid >> 5;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (l >= off) x += y;
  }
  if (l == 31) s_warp[w] = x;
  __syncthreads();
  if (w == 0) {
    int t = l < kPickWarps ? s_warp[l] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (l >= off) t += y;
    }
    if (l < kPickWarps) s_warp[l] = t;  // inclusive warp totals
  }
  __syncthreads();
  const int out = x - v + (w ? s_warp[w - 1] : 0);
  __syncthreads();  // s_warp is free again
  return out;
}

// Part blockIdx.x of query blockIdx.y: grid (nsplit, B); NT as
// block_bound's.
template <int NT>
__global__ void __launch_bounds__(kPickThreads,
                                  NT >= 1 && NT <= 2 ? 4 : 3)
    pick_kernel(PickArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[4096];
  __shared__ unsigned csum[256];
  __shared__ int s_warp[kPickWarps];
  __shared__ unsigned s_digit, s_rem, s_cnt, s_val;
  __shared__ int s_n;
  __shared__ int s_last;
  const int part = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int wl = tid & 31;
  const int T = a.T;
  const long long NB = a.NB;
  WCLK_START
  long long* s_off = reinterpret_cast<long long*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + align16(8LL * T));
  float* Us = reinterpret_cast<float*>(smem + align16(8LL * T) +
                                       align16(4LL * T));
  float* Ug = a.ub_scratch ? a.ub_scratch + (long long)b * NB : nullptr;
  for (int t = tid; t < T; t += kPickThreads) {
    s_off[t] = clamp_row(a.slots[(long long)b * T + t], a.H) * NB;
    s_w[t] = a.weights[(long long)b * T + t];
  }
  __syncthreads();
  // this part's bounds: into shared memory, or the scratch where the
  // select reads them from device memory or they come from several parts
  const bool to_smem = a.ub_smem && a.nsplit == 1;
  float* U = to_smem ? Us : Ug;
  const long long chunk = (NB + a.nsplit - 1) / a.nsplit;
  const long long lo = min(NB, part * chunk), hi = min(NB, lo + chunk);
  // two blocks a thread at a time, so both blocks' loads are in flight
  for (long long k = lo + tid; k < hi; k += 2 * kPickThreads) {
    const long long k2 = k + kPickThreads;
    const float u1 = block_bound<NT>(a, s_off, s_w, k);
    const float u2 = k2 < hi ? block_bound<NT>(a, s_off, s_w, k2) : 0.f;
    U[k] = u1;
    if (k2 < hi) U[k2] = u2;
  }
  WCLK(8);
  if (a.nsplit > 1) {
    // the last part of the query to finish selects
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicAdd(a.done + b, 1u) == (unsigned)(a.nsplit - 1);
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (a.ub_smem) {
      for (long long k = tid; k < NB; k += kPickThreads) Us[k] = __ldcg(Ug + k);
      U = Us;
    }
  }
  __syncthreads();
  WCLK(9);
  const bool global = U != Us;
  auto load = [&](long long k) { return global ? __ldcg(U + k) : U[k]; };

  // the (C+1)-th largest order_bits, a digit at a time from the top:
  // digits of 12, 10 and 10 bits, each pass's histogram in shared
  // memory, then, once few bounds have the prefix, those ranked
  unsigned prefix = 0, rem = a.C + 1;
  int known = 0;  // the top bits of prefix found
  for (int pass = 0; pass < 3; ++pass) {
    const int width = pass == 0 ? 12 : 10;
    const int shift = 32 - known - width;
    const int nbins = 1 << width, per = nbins >> 8;
    const unsigned hi_mask = known ? ~0u << (32 - known) : 0u;
    for (int i = tid; i < nbins; i += kPickThreads) hist[i] = 0;
    __syncthreads();
    // the digit most of a warp's lanes share (bounds of one query differ
    // in few top digits) is counted in a register, warp-uniform, while
    // it stays the same, and added once; any other lane adds its own one
    unsigned run_d = 0, run_n = 0;
    for (long long k0 = 0; k0 < NB; k0 += kPickThreads) {
      const long long k = k0 + tid;
      bool in = false;
      unsigned d = 0;
      if (k < NB) {
        const unsigned u = order_bits(load(k));
        in = (u & hi_mask) == prefix;
        d = (u >> shift) & (nbins - 1);
      }
      const unsigned act = __ballot_sync(0xffffffffu, in);
      if (act) {
        const unsigned dl = __shfl_sync(0xffffffffu, d, __ffs(act) - 1);
        const unsigned same = __ballot_sync(0xffffffffu, in && d == dl);
        if (dl != run_d) {
          if (wl == 0 && run_n) atomicAdd(&hist[run_d], run_n);
          run_d = dl;
          run_n = 0;
        }
        run_n += __popc(same);
        if (in && d != dl) atomicAdd(&hist[d], 1u);
      }
    }
    if (wl == 0 && run_n) atomicAdd(&hist[run_d], run_n);
    __syncthreads();
    // 256 runs of per bins from the top digit down, their sums, then
    // warp 0 finds the run and the digit holding the rem-th bound
    for (int c = tid; c < 256; c += kPickThreads) {
      unsigned sum = 0;
      for (int i = 0; i < per; ++i) sum += hist[nbins - 1 - c * per - i];
      csum[c] = sum;
    }
    __syncthreads();
    if (tid < 32) {
      unsigned sum = 0;
      for (int i = 0; i < 8; ++i) sum += csum[tid * 8 + i];
      unsigned incl = sum;
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += y;
      }
      const unsigned q = __ballot_sync(0xffffffffu, incl >= rem);
      if (tid == __ffs(q) - 1) {
        unsigned cum = incl - sum;
        bool found = false;
        for (int c = tid * 8; c < tid * 8 + 8 && !found; ++c) {
          if (cum + csum[c] < rem) {
            cum += csum[c];
            continue;
          }
          for (int i = 0; i < per && !found; ++i) {
            const int d = nbins - 1 - c * per - i;
            if (cum + hist[d] >= rem) {
              s_digit = d;
              s_rem = rem - cum;
              s_cnt = hist[d];
              found = true;
            } else {
              cum += hist[d];
            }
          }
        }
      }
    }
    __syncthreads();
    prefix |= s_digit << shift;
    rem = s_rem;
    known += width;
    WCLK_COUNT(13);
    if (known < 32 && s_cnt <= kPickThreads) {
      // few bounds have this prefix: gather them (value bits, id) and
      // rank them, the (C+1)-th is the one with rem - 1 above it in
      // (value desc, id asc) order
      const unsigned mask = ~0u << (32 - known);
      unsigned* cu = hist;
      unsigned* ck = hist + kPickThreads;
      if (tid == 0) s_n = 0;
      __syncthreads();
      for (long long k0 = 0; k0 < NB; k0 += kPickThreads) {
        const long long k = k0 + tid;
        const unsigned u = k < NB ? order_bits(load(k)) : 0u;
        const bool in = k < NB && (u & mask) == prefix;
        const unsigned m = __ballot_sync(0xffffffffu, in);
        if (m) {
          int at = 0;
          if (wl == __ffs(m) - 1) at = atomicAdd(&s_n, __popc(m));
          at = __shfl_sync(0xffffffffu, at, __ffs(m) - 1);
          if (in) {
            const int i = at + __popc(m & ((1u << wl) - 1));
            cu[i] = u;
            ck[i] = (unsigned)k;
          }
        }
      }
      __syncthreads();
      const int n = s_n;
      if (tid < n) {
        const unsigned u = cu[tid], k = ck[tid];
        int above = 0, eq_before = 0;
        for (int i = 0; i < n; ++i) {
          above += cu[i] > u || (cu[i] == u && ck[i] < k);
          eq_before += cu[i] == u && ck[i] < k;
        }
        if (above == (int)rem - 1) {
          s_val = u;
          s_rem = eq_before + 1;
        }
      }
      __syncthreads();
      prefix = s_val;
      rem = s_rem;
      WCLK_COUNT(14);
      break;
    }
  }
  WCLK(10);
  // the C picked: every block above prefix, and the first rem - 1 equal
  // to it in id order; the rem-th equal one is the (C+1)-th
  // each thread a run of span consecutive ids; up to 32 ids a thread,
  // their comparisons kept as bits, read in a rotated order (a run's
  // threads then read distinct banks) and the run walked in id order
  const long long span = (NB + kPickThreads - 1) / kPickThreads;
  const long long clo = min(NB, tid * span), chi = min(NB, clo + span);
  const int len = (int)(chi - clo);
  int n_gt = 0, n_eq = 0;
  unsigned gt_bits = 0, eq_bits = 0;
  if (span <= 32) {
    for (int i0 = 0; i0 < len; ++i0) {
      const int i = (i0 + tid) % len;
      const unsigned u = order_bits(load(clo + i));
      gt_bits |= (unsigned)(u > prefix) << i;
      eq_bits |= (unsigned)(u == prefix) << i;
    }
    n_gt = __popc(gt_bits);
    n_eq = __popc(eq_bits);
  } else {
    for (long long k = clo; k < chi; ++k) {
      const unsigned u = order_bits(load(k));
      n_gt += u > prefix;
      n_eq += u == prefix;
    }
  }
  const int eq0 = cta_exclusive_scan(n_eq, s_warp);
  const int take = max(0, min(n_eq, (int)rem - 1 - eq0));
  int pos = cta_exclusive_scan(n_gt + take, s_warp);
  long long* out = a.blk + (long long)b * a.C;
  int r = eq0;
  if (span <= 32) {
    for (unsigned m = gt_bits | eq_bits; m; m &= m - 1) {
      const int i = __ffs(m) - 1;
      if (gt_bits >> i & 1) {
        out[pos++] = clo + i;
      } else {
        if (r < (int)rem - 1) out[pos++] = clo + i;
        if (r == (int)rem - 1) a.next_ub[b] = load(clo + i);
        ++r;
      }
    }
  } else {
    for (long long k = clo; k < chi; ++k) {
      const float v = load(k);
      const unsigned u = order_bits(v);
      if (u > prefix) {
        out[pos++] = k;
      } else if (u == prefix) {
        if (r < (int)rem - 1) out[pos++] = k;
        if (r == (int)rem - 1) a.next_ub[b] = v;
        ++r;
      }
    }
  }
  WCLK(11);
  WCLK_COUNT(12);
}

template <typename F>
cudaError_t raise_smem(F* kernel, long long smem) {
  if (smem <= (48 << 10)) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NT>
cudaError_t launch_pick(const PickArgs& a, long long smem, cudaStream_t s) {
  cudaError_t err = raise_smem(pick_kernel<NT>, smem);
  if (err != cudaSuccess) return err;
  pick_kernel<NT><<<dim3(a.nsplit, a.B), kPickThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool TC, int KIND>
cudaError_t launch_scan(const ScanArgs& a, long long smem, long long msmem,
                        cudaStream_t s) {
  cudaError_t err = raise_smem(scan_kernel<TC, KIND>, smem);
  if (err != cudaSuccess) return err;
  // tc's device table, before every scan that reads it first (the listed
  // selection reads the one its sweep's launch wrote)
  if (TC && KIND != kBand && !(KIND == kSelect && a.bkeys)) {
    tc_norm_kernel<<<256, 256, 0, s>>>(a.avg32, a.norm_g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (KIND == kBand) {
    err = cudaMemsetAsync(a.hit, 0, sizeof(int32_t) * a.B, s);
    if (err != cudaSuccess) return err;
  }
  if (KIND == kSelect && a.nseg > 1) {
    // a query's segments are one cluster, merged in its first CTA
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)a.nseg, (unsigned)a.B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.nseg;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, scan_kernel<TC, KIND>, a);
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  scan_kernel<TC, KIND><<<dim3(a.nseg, a.B), kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nseg == 1 || KIND != kScan) return err;
  err = raise_smem(merge_kernel<TC>, msmem);
  if (err != cudaSuccess) return err;
  merge_kernel<TC><<<a.B, kThreads, msmem, s>>>(a);
  return cudaGetLastError();
}

template <bool TC, int KIND>
int resident(long long smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = raise_smem(scan_kernel<TC, KIND>, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, scan_kernel<TC, KIND>, kThreads, (size_t)smem);
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

template <int KIND>
int launch_kind(const ScanArgs& a, long long smem, long long msmem,
                cudaStream_t s) {
  return (int)(a.tf8 ? launch_scan<true, KIND>(a, smem, msmem, s)
                     : launch_scan<false, KIND>(a, smem, msmem, s));
}

}  // namespace wiser_dense

extern "C" {

// The wrappers' arguments (ops/dense._ScanParams and _PickParams, every
// field 8 bytes): pointers to device memory or 0, counts, and the plan.
struct WiserDenseScanParams {
  long long sc, tf, tf8, code, avg32, norm_g, slots, weights, blocks;
  long long H, N_pad, B, T, M, nblk, K, KP, nseg, bps, NS, SB;
  long long smem, merge_smem;
  long long part_keys, rscratch, top_docs, top_score, top_tfs, flags;
  long long kind, sel_lanes, sel_score, thr, kth_doc, hit, bkeys;
};

struct WiserDensePickParams {
  long long bm, bm2, ap, slots, weights, H, NB, B, T, C, nsplit, ub_smem;
  long long smem, ub_scratch, done, blk, next_ub;
};

// The scan's CTAs the card holds at once (SMs times CTAs an SM) at this
// shared-memory size, or minus a CUDA error code; kind 0 the dense scan,
// 1 the phrase's selection, 2 its band pass, 3 its block-key sweep.
int wiser_dense_resident(int tc, int kind, long long smem) {
  using namespace wiser_dense;
  if (kind == kSelect)
    return tc ? resident<true, kSelect>(smem) : resident<false, kSelect>(smem);
  if (kind == kBand)
    return tc ? resident<true, kBand>(smem) : resident<false, kBand>(smem);
  if (kind == kSweep)
    return tc ? resident<true, kSweep>(smem) : resident<false, kSweep>(smem);
  return tc ? resident<true, kScan>(smem) : resident<false, kScan>(smem);
}

// Launch the scan of `kind` on `stream` (no synchronize), after tc's
// table where it reads it first: the dense scan in one launch, or two
// where nseg > 1; the phrase's selection in one (a query's nseg <= 8
// segments one cluster), over every block, or, with bkeys, over the
// blocks its sweep's keys pick (nblk = K ranks); the band in one, after
// zeroing its words; the sweep in one, writing bkeys. Returns the first
// launch error (0 on success); a plan whose shared bytes disagree with
// this file's layout, or whose grid the card cannot run, is refused as
// cudaErrorInvalidValue before any launch.
int wiser_dense_scan(const WiserDenseScanParams* p, void* stream) {
  using namespace wiser_dense;
  ScanArgs a;
  a.sc = (const float*)p->sc;
  a.tf = (const int32_t*)p->tf;
  a.tf8 = (const uint8_t*)p->tf8;
  a.code = (const uint8_t*)p->code;
  a.avg32 = (const float*)p->avg32;
  a.norm_g = (float*)p->norm_g;
  a.slots = (const int32_t*)p->slots;
  a.weights = (const float*)p->weights;
  a.blocks = (const long long*)p->blocks;
  a.H = p->H;
  a.N_pad = p->N_pad;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.M = (int)p->M;
  a.nblk = (int)p->nblk;
  a.K = (int)p->K;
  a.KP = (int)p->KP;
  a.nseg = (int)p->nseg;
  a.bps = (int)p->bps;
  a.NS = (int)p->NS;
  a.SB = (int)p->SB;
  a.part_keys = (unsigned long long*)p->part_keys;
  a.rscratch = (unsigned long long*)p->rscratch;
  a.top_docs = (int32_t*)p->top_docs;
  a.top_score = (float*)p->top_score;
  a.top_tfs = (int32_t*)p->top_tfs;
  a.flags = (int32_t*)p->flags;
  a.sel_lanes = (const int32_t*)p->sel_lanes;
  a.sel_score = (const float*)p->sel_score;
  a.thr = (const float*)p->thr;
  a.kth_doc = (const int32_t*)p->kth_doc;
  a.hit = (int32_t*)p->hit;
  a.bkeys = (unsigned long long*)p->bkeys;
  const int kind = (int)p->kind;
  const bool tc = a.tf8 != nullptr;
  const bool band = kind == kBand;
  const bool sel = kind == kSelect;
  const bool sweep = kind == kSweep;
  const bool listed = a.blocks != nullptr || ((sel || band) && a.bkeys);
  const long long NB = a.N_pad / 128;
  const ScanLayout L = scan_layout(tc, listed, a.T, a.KP, a.NS, a.SB, sel);
  // the listed selection's pick: its block keys over the ring and lists
  const long long smem =
      sel && a.bkeys && L.ring + pick_smem(NB) > L.total
          ? L.ring + pick_smem(NB)
          : L.total;
  const long long msmem = merge_bytes(a.KP);
  if (kind < kScan || kind > kSweep ||
      (kind != kScan && (a.blocks || a.K < 2 || a.K > a.N_pad)) ||
      ((band || sweep) && (a.KP || a.rscratch || a.part_keys)) ||
      (band && (!a.hit || !a.sel_lanes || !a.sel_score || !a.thr ||
                (tc && !a.kth_doc) || a.T > kBandMaxT)) ||
      (sweep && (!a.bkeys || a.nblk != NB)) ||
      (band && a.bkeys && a.nblk != NB) ||
      (sel && (a.rscratch || a.part_keys || a.nseg > kMaxCluster ||
               (a.bkeys ? a.nblk != a.K || NB < a.K : a.nblk != NB))))
    return (int)cudaErrorInvalidValue;
  if (smem != p->smem ||
      (a.nseg > 1 && kind == kScan && msmem != p->merge_smem) ||
      a.K != a.M + 1 || (!band && !sweep && a.K > a.KP) || a.nseg < 1 ||
      a.B < 1 || a.B > 65535 || (listed && a.bps > kIdsCap) ||
      a.NS < 2 || a.NS > kMaxStages || a.SB < 1 ||
      a.SB > kMaxStepBlocks || a.bps < 1 || a.bps % a.SB ||
      (kind == kScan && a.nseg > 1 && !a.part_keys) ||
      (kind == kScan && keys_in_smem(a.KP) != (a.rscratch == nullptr)) ||
      (tc && !band && !a.norm_g) ||
      (long long)a.nseg * a.bps < a.nblk ||
      (long long)(a.nseg - 1) * a.bps >= a.nblk || a.N_pad % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (sel) return launch_kind<kSelect>(a, smem, msmem, s);
  if (band) return launch_kind<kBand>(a, smem, msmem, s);
  if (sweep) return launch_kind<kSweep>(a, smem, msmem, s);
  return launch_kind<kScan>(a, smem, msmem, s);
}

// Launch the pick on `stream` (no synchronize): nsplit CTAs a query
// (their done words zeroed first where nsplit > 1).
int wiser_dense_pick(const WiserDensePickParams* p, void* stream) {
  using namespace wiser_dense;
  PickArgs a;
  a.bm = (const float*)p->bm;
  a.bm2 = (const float*)p->bm2;
  a.ap = (const uint8_t*)p->ap;
  a.slots = (const int32_t*)p->slots;
  a.weights = (const float*)p->weights;
  a.H = p->H;
  a.NB = p->NB;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.C = (int)p->C;
  a.nsplit = (int)p->nsplit;
  a.ub_smem = (int)p->ub_smem;
  a.ub_scratch = (float*)p->ub_scratch;
  a.done = (unsigned*)p->done;
  a.blk = (long long*)p->blk;
  a.next_ub = (float*)p->next_ub;
  const long long smem = pick_bytes(a.T, a.NB, a.ub_smem);
  if (smem != p->smem || (a.ub_smem && 4 * a.NB > kUbSmemBytes) ||
      a.C < 1 || a.C + 1 > a.NB || (a.bm2 && !a.ap) || a.nsplit < 1 ||
      a.nsplit > 65535 || a.B > 65535 ||
      ((!a.ub_smem || a.nsplit > 1) && !a.ub_scratch) ||
      (a.nsplit > 1 && !a.done))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a.nsplit > 1) {
    const cudaError_t err =
        cudaMemsetAsync(a.done, 0, sizeof(unsigned) * a.B, s);
    if (err != cudaSuccess) return (int)err;
  }
  switch (a.T) {
    case 1: return (int)launch_pick<1>(a, smem, s);
    case 2: return (int)launch_pick<2>(a, smem, s);
    case 3: return (int)launch_pick<3>(a, smem, s);
    case 4: return (int)launch_pick<4>(a, smem, s);
    case 5: return (int)launch_pick<5>(a, smem, s);
    case 6: return (int)launch_pick<6>(a, smem, s);
    case 7: return (int)launch_pick<7>(a, smem, s);
    case 8: return (int)launch_pick<8>(a, smem, s);
    default: return (int)launch_pick<0>(a, smem, s);
  }
}

// tc_norm_kernel alone on `stream` (no synchronize): avg32 one f32, out
// (256, 256) f32. The scan launches it itself; this entry is for the
// checks and timings.
int wiser_dense_tc_table(const float* avg32, float* out, void* stream) {
  wiser_dense::tc_norm_kernel<<<256, 256, 0, (cudaStream_t)stream>>>(avg32,
                                                                     out);
  return (int)cudaGetLastError();
}

const char* wiser_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

WISER_CLOCKS_READER(wiser_dense_clocks, wiser_dense)
