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
// arithmetic is a few operations a byte. The plain version moves several
// times that: a (B, N_pad) f32 score plane, a bool match plane and one
// gathered (B, N_pad) row a slot are each written to device memory and
// read back, and its top-M reads the plane twice more (512 MB a plane at
// B 128 and 1M docs). This form keeps every lane in registers:
//   - a CTA of 256 threads takes one (query, segment of blocks) pair and
//     streams each slot's row segment with 16-byte loads (4 f32 lanes a
//     thread raw, 16 tf bytes tc, and the len-code row's 16 bytes once for
//     every slot), summing and masking in registers; in tc the length term
//     of each lane is computed once for all its slots;
//   - matched lanes whose 64-bit key (keys.cuh: ordered score bits above
//     the inverted doc) passes the running K-th key (K = M + 1) are
//     compacted into a shared-memory buffer (one atomic a warp and lane
//     slot); when the buffer holds a step's worth of keys it is sorted and
//     merged by rank into the running top K, which raises the threshold
//     (the running lists in shared memory up to 4,096 keys, past that in
//     a device scratch, so any M runs); no (B, N_pad) or (B, C * 128)
//     plane ever reaches device memory;
//   - keys are unique, so ties fall to the lowest doc on every row, the
//     set is exact at every lane-set size (the plain version's flat top-k
//     below M + 1 blocks and its two-level one above both keep it), and
//     FLAG_TRUNC reads the (M+1)-th key;
//   - a group too narrow to fill the card splits each query's blocks into
//     nseg segments; each leaves its K keys, and a second launch
//     (merge_kernel) merges them per query. The winners' tfs come from
//     the keys' docs, with no second pass over the lanes.
//
// pick_kernel: one CTA a query computes every block's bound into shared
// memory (device scratch past kUbSmemBytes): raw the plain sum bm_0 * w_0
// + bm_1 * w_1 + ... in slot order; with blockmax2 and argpos the max
// over anchors ts of bm_ts * w_ts + sum over t != ts, in slot order, of
// (argpos_t == argpos_ts ? bm_t : bm2_t) * w_t; 0 where a live slot
// (w != 0) has blockmax <= 0. A radix select over the bounds' ordered bits
// (four 8-bit digits, a warp's scan of each histogram) finds the
// (C+1)-th largest value v; the blocks above v and the lowest-id blocks
// equal to it are compacted in id order by two block-wide prefix counts,
// which keeps the pick stable (equal bounds go to the lowest ids, as
// lax.top_k keeps them) and leaves the C ids ascending; next_ub is the
// bound of the (C+1)-th. Bound: bytes, each slot's blockmax row (and
// blockmax2 and argpos, 9 B a block) read once.
//
// Arithmetic: every f32 operation is an explicit round-to-nearest
// intrinsic and the library is built with -fmad=false, so scores and
// bounds equal the plain version's bit for bit. Offsets into the planes
// (row * N_pad + doc, row * NB + blk) and the outputs are 64-bit.

#include <cstdint>
#include <cuda_runtime.h>

#include "keys.cuh"

namespace wiser_dense {

using namespace wiser_keys;

constexpr int kThreads = 256;      // the scan's and the merge's CTA
constexpr int kPickThreads = 512;  // the pick's CTA
// the running lists (R, R2) live in shared memory up to this KP, past it
// in a device scratch the wrapper allocates (a K = M + 1 of any size)
constexpr int kKeySmemCap = 4096;
constexpr int kMiscBytes = 16;     // the scan's step counters
// the pick keeps its NB bounds in shared memory up to this many bytes
constexpr long long kUbSmemBytes = 200 * 1024;

struct ScanArgs {
  const float* sc;          // raw: (H, N_pad) f32 scores
  const int32_t* tf;        // raw: (H, N_pad) i32 tfs
  const uint8_t* tf8;       // tc: (H, N_pad) u8 tfs; null on raw planes
  const uint8_t* code;      // tc: (N_pad,) u8 len codes
  const float* avg32;       // tc: one f32
  const int32_t* slots;     // (B, T) rows
  const float* weights;     // (B, T) use_score (raw) or idf32 (tc)
  const long long* blocks;  // (B, nblk) ascending block ids; null: every block
  long long H, N_pad;
  int B, T, M, nblk, K, KP, nseg, bps;
  unsigned long long* part_keys;  // (B, nseg, K) when nseg > 1
  unsigned long long* rscratch;   // (B, nseg, 2, KP) when KP > kKeySmemCap
  int32_t* top_docs;  // (B, M)
  float* top_score;   // (B, M)
  int32_t* top_tfs;   // (B, T, M)
  int32_t* flags;     // (B,)
};

__host__ __device__ constexpr long long align16(long long x) {
  return (x + 15) & ~15LL;
}

// Lanes a thread holds: one 16-byte load of a row segment.
template <bool TC>
__host__ __device__ constexpr int lanes_per_thread() {
  return TC ? 16 : 4;
}

// Lanes a step of the CTA covers, and the key buffer's flush point; the
// buffer holds twice that (a power of 2, so it sorts in place).
template <bool TC>
__host__ __device__ constexpr int step_lanes() {
  return kThreads * lanes_per_thread<TC>();
}

__host__ __device__ constexpr bool keys_in_smem(int KP) {
  return KP <= kKeySmemCap;
}

// The scan's shared bytes: the counters | T row offsets | T weights | R
// and R2 (KP keys each, up to kKeySmemCap) | X (2 * step_lanes keys).
// ops/dense.plan computes the same.
template <bool TC>
__host__ __device__ constexpr long long scan_bytes(int T, int KP) {
  return kMiscBytes + align16(8LL * T) + align16(4LL * T) +
         (keys_in_smem(KP) ? 16LL * KP : 0) + 16LL * step_lanes<TC>();
}

// The merge's: R, R2 and the list read in (none past kKeySmemCap: then R
// and R2 are the scratch and the lists are read in place).
__host__ __device__ constexpr long long merge_bytes(int KP) {
  return keys_in_smem(KP) ? 24LL * KP : 0;
}

__device__ __forceinline__ long long clamp_row(int r, long long H) {
  return r < 0 ? 0 : (r >= H ? H - 1 : r);
}

// The outputs of query b from its descending keys (at least K readable,
// 0-padded).
template <bool TC>
__device__ void write_outputs(const ScanArgs& a, int b,
                              const unsigned long long* keys, int tid) {
  const int T = a.T, M = a.M;
  const float ninf = -__int_as_float(0x7f800000);
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

// One (segment, query) pair a CTA: grid (nseg, B).
template <bool TC>
__global__ void __launch_bounds__(kThreads) scan_kernel(ScanArgs a) {
  constexpr int LPT = lanes_per_thread<TC>();
  constexpr int SL = step_lanes<TC>();
  constexpr int SB = SL / 128;  // blocks a step
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int seg = blockIdx.x, b = blockIdx.y;
  const int T = a.T, KP = a.KP;
  int* cnt = reinterpret_cast<int*>(smem);  // 3 step counters
  long long* s_off = reinterpret_cast<long long*>(smem + kMiscBytes);
  float* s_w = reinterpret_cast<float*>(smem + kMiscBytes + align16(8LL * T));
  unsigned char* const keys =
      smem + kMiscBytes + align16(8LL * T) + align16(4LL * T);
  unsigned long long* R =
      a.rscratch ? a.rscratch + ((long long)b * a.nseg + seg) * 2 * KP
                 : reinterpret_cast<unsigned long long*>(keys);
  unsigned long long* R2 = R + KP;
  unsigned long long* X = a.rscratch
                              ? reinterpret_cast<unsigned long long*>(keys)
                              : R2 + KP;
  for (int t = tid; t < T; t += kThreads) {
    s_off[t] = clamp_row(a.slots[(long long)b * T + t], a.H) * a.N_pad;
    s_w[t] = a.weights[(long long)b * T + t];
  }
  for (int i = tid; i < KP; i += kThreads) R[i] = 0ull;
  if (tid < 3) cnt[tid] = 0;
  __syncthreads();
  const float avg = TC ? *a.avg32 : 0.f;
  const long long NB = a.N_pad >> 7;
  const int blk_lo = seg * a.bps;
  const int blk_hi = min(a.nblk, blk_lo + a.bps);
  const int sub = (tid * LPT) >> 7;      // this thread's block in a step
  const int lane0 = (tid * LPT) & 127;   // its first lane in the block
  const unsigned lt = (1u << (tid & 31)) - 1;
  int base = 0;  // keys in X before this step
  int step = 0;
  auto flush = [&](int c) {
    sort_keys<kThreads>(X, c, tid);
    merge_ranks<kThreads, false>(R, nullptr, R2, nullptr, KP, X, nullptr,
                                 min(c, a.K), 0u, tid);
    unsigned long long* r = R;
    R = R2;
    R2 = r;
  };
  for (int s0 = blk_lo; s0 < blk_hi; s0 += SB, ++step) {
    const int i = s0 + sub;
    const bool active = i < blk_hi;
    unsigned match = 0;
    float acc[LPT];
    long long doc0 = 0;
#pragma unroll
    for (int j = 0; j < LPT; ++j) acc[j] = 0.f;
    if (active) {
      long long blk = a.blocks ? a.blocks[(long long)b * a.nblk + i] : i;
      blk = blk < 0 ? 0 : (blk >= NB ? NB - 1 : blk);
      doc0 = blk * 128 + lane0;
      match = (1u << LPT) - 1;
      if (TC) {
        const uint4 cq = *reinterpret_cast<const uint4*>(a.code + doc0);
        const unsigned cw[4] = {cq.x, cq.y, cq.z, cq.w};
        float cache[LPT];
#pragma unroll
        for (int j = 0; j < LPT; ++j)
          cache[j] = tc_cache((cw[j >> 2] >> (8 * (j & 3))) & 0xFF, avg);
        for (int t = 0; t < T; ++t) {
          const uint4 q =
              *reinterpret_cast<const uint4*>(a.tf8 + s_off[t] + doc0);
          const unsigned qw[4] = {q.x, q.y, q.z, q.w};
          const float w = s_w[t];
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            const int tf = (qw[j >> 2] >> (8 * (j & 3))) & 0xFF;
            if (tf) {
              acc[j] = __fadd_rn(acc[j], tc_score_cached(tf, cache[j], w));
            } else {
              match &= ~(1u << j);
            }
          }
        }
      } else {
        for (int t = 0; t < T; ++t) {
          const float4 q =
              *reinterpret_cast<const float4*>(a.sc + s_off[t] + doc0);
          const float v[4] = {q.x, q.y, q.z, q.w};
          const float w = s_w[t];
#pragma unroll
          for (int j = 0; j < LPT; ++j) {
            if (!(v[j] > 0.f)) match &= ~(1u << j);
            acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], w));
          }
        }
      }
    }
    // the matched keys above the running K-th, compacted into X after
    // the keys of earlier steps; R changes only between barriers
    const unsigned long long tau = R[a.K - 1];
    int* count = cnt + step % 3;
#pragma unroll
    for (int j = 0; j < LPT; ++j) {
      unsigned long long key = 0ull;
      if (match >> j & 1) key = tile_key(acc[j], (int)(doc0 + j));
      const bool pass = key > tau;
      const unsigned m = __ballot_sync(0xffffffffu, pass);
      if (m) {
        int at = 0;
        if ((tid & 31) == __ffs(m) - 1) at = atomicAdd(count, __popc(m));
        at = __shfl_sync(0xffffffffu, at, __ffs(m) - 1);
        if (pass) X[base + at + __popc(m & lt)] = key;
      }
    }
    __syncthreads();
    // this step's counter is read by every thread before the next
    // barrier; the one two steps on was last read before this barrier
    const int c = base + *count;
    if (tid == 0) cnt[(step + 2) % 3] = 0;
    if (c >= SL) {
      flush(c);
      base = 0;
    } else {
      base = c;
    }
  }
  if (base) flush(base);
  __syncthreads();
  if (a.nseg == 1) {
    write_outputs<TC>(a, b, R, tid);
  } else {
    const long long o = ((long long)b * a.nseg + seg) * a.K;
    for (int i = tid; i < a.K; i += kThreads) a.part_keys[o + i] = R[i];
  }
}

// The second launch where a query's blocks span nseg segments: one CTA a
// query merges their nseg lists of K keys and writes the outputs.
template <bool TC>
__global__ void __launch_bounds__(kThreads) merge_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = a.KP, K = a.K;
  const int b = blockIdx.x, tid = threadIdx.x;
  // past kKeySmemCap: R and R2 in the first segment's scratch (its scan
  // is done), each list merged where it lies
  unsigned long long* R =
      a.rscratch ? a.rscratch + (long long)b * a.nseg * 2 * KP
                 : reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* R2 = R + KP;
  unsigned long long* Q = a.rscratch ? nullptr : R2 + KP;
  const long long o = (long long)b * a.nseg * K;
  for (int i = tid; i < KP; i += kThreads)
    R[i] = i < K ? a.part_keys[o + i] : 0ull;
  for (int s = 1; s < a.nseg; ++s) {
    const unsigned long long* list = a.part_keys + o + (long long)s * K;
    if (Q) {
      for (int i = tid; i < K; i += kThreads) Q[i] = list[i];
      list = Q;
    }
    __syncthreads();
    merge_ranks<kThreads, false>(R, nullptr, R2, nullptr, KP, list, nullptr,
                                 list_length(list, K), 0u, tid);
    unsigned long long* r = R;
    R = R2;
    R2 = r;
  }
  __syncthreads();
  write_outputs<TC>(a, b, R, tid);
}

struct PickArgs {
  const float* bm;    // (H, NB) block maxima
  const float* bm2;   // (H, NB) second maxima, or null: the plain sum
  const uint8_t* ap;  // (H, NB) argmax lanes
  const int32_t* slots;   // (B, T)
  const float* weights;   // (B, T) the bound's multipliers
  long long H, NB;
  int B, T, C;
  float* ub_scratch;  // (B, NB) when the bounds leave shared memory
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
    int t = l < kPickThreads / 32 ? s_warp[l] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, off);
      if (l >= off) t += y;
    }
    if (l < kPickThreads / 32) s_warp[l] = t;  // inclusive warp totals
  }
  __syncthreads();
  const int out = x - v + (w ? s_warp[w - 1] : 0);
  __syncthreads();  // s_warp is free again
  return out;
}

__global__ void __launch_bounds__(kPickThreads) pick_kernel(PickArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[256];
  __shared__ int s_warp[kPickThreads / 32];
  __shared__ unsigned s_digit, s_rem;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int T = a.T;
  const long long NB = a.NB;
  long long* s_off = reinterpret_cast<long long*>(smem);
  float* s_w = reinterpret_cast<float*>(smem + align16(8LL * T));
  float* U = a.ub_scratch
                 ? a.ub_scratch + (long long)b * NB
                 : reinterpret_cast<float*>(smem + align16(8LL * T) +
                                            align16(4LL * T));
  for (int t = tid; t < T; t += kPickThreads) {
    s_off[t] = clamp_row(a.slots[(long long)b * T + t], a.H) * NB;
    s_w[t] = a.weights[(long long)b * T + t];
  }
  __syncthreads();
  const float ninf = -__int_as_float(0x7f800000);
  for (long long k = tid; k < NB; k += kPickThreads) {
    bool feas = true;
    float ub = 0.f;
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
    U[k] = feas ? ub : 0.f;
  }
  __syncthreads();

  // the (C+1)-th largest order_bits, a digit at a time from the top
  unsigned prefix = 0, rem = a.C + 1;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += kPickThreads) hist[i] = 0;
    __syncthreads();
    for (long long k = tid; k < NB; k += kPickThreads) {
      const unsigned u = order_bits(U[k]);
      if (shift == 24 || (u >> (shift + 8)) == (prefix >> (shift + 8)))
        atomicAdd(&hist[(u >> shift) & 255], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l
      unsigned sum = 0;
      for (int i = 0; i < 8; ++i) sum += hist[255 - 8 * tid - i];
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
          if (cum + hist[d] >= rem) {
            s_digit = d;
            s_rem = rem - cum;
            break;
          }
          cum += hist[d];
        }
      }
    }
    __syncthreads();
    prefix |= s_digit << shift;
    rem = s_rem;
  }
  // the C picked: every block above prefix, and the first rem - 1 equal
  // to it in id order; the rem-th equal one is the (C+1)-th
  const long long chunk = (NB + kPickThreads - 1) / kPickThreads;
  const long long lo = min(NB, tid * chunk), hi = min(NB, lo + chunk);
  int n_gt = 0, n_eq = 0;
  for (long long k = lo; k < hi; ++k) {
    const unsigned u = order_bits(U[k]);
    n_gt += u > prefix;
    n_eq += u == prefix;
  }
  const int eq0 = cta_exclusive_scan(n_eq, s_warp);
  const int take = max(0, min(n_eq, (int)rem - 1 - eq0));
  int pos = cta_exclusive_scan(n_gt + take, s_warp);
  long long* out = a.blk + (long long)b * a.C;
  int r = eq0;
  for (long long k = lo; k < hi; ++k) {
    const unsigned u = order_bits(U[k]);
    if (u > prefix) {
      out[pos++] = k;
    } else if (u == prefix) {
      if (r < (int)rem - 1) out[pos++] = k;
      if (r == (int)rem - 1) a.next_ub[b] = U[k];
      ++r;
    }
  }
}

template <typename F>
cudaError_t raise_smem(F* kernel, long long smem) {
  if (smem <= (48 << 10)) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool TC>
cudaError_t launch_scan(const ScanArgs& a, long long smem, long long msmem,
                        cudaStream_t s) {
  cudaError_t err = raise_smem(scan_kernel<TC>, smem);
  if (err != cudaSuccess) return err;
  scan_kernel<TC><<<dim3(a.nseg, a.B), kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.nseg == 1) return err;
  err = raise_smem(merge_kernel<TC>, msmem);
  if (err != cudaSuccess) return err;
  merge_kernel<TC><<<a.B, kThreads, msmem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace wiser_dense

extern "C" {

// The wrappers' arguments (ops/dense._ScanParams and _PickParams, every
// field 8 bytes): pointers to device memory or 0, counts, and the plan.
struct WiserDenseScanParams {
  long long sc, tf, tf8, code, avg32, slots, weights, blocks;
  long long H, N_pad, B, T, M, nblk, K, KP, nseg, bps, smem, merge_smem;
  long long part_keys, rscratch, top_docs, top_score, top_tfs, flags;
};

struct WiserDensePickParams {
  long long bm, bm2, ap, slots, weights, H, NB, B, T, C, smem;
  long long ub_scratch, blk, next_ub;
};

// Launch the scan on `stream` (no synchronize): one launch, or two where
// nseg > 1. Returns the first launch error (0 on success); a plan whose
// shared bytes disagree with this file's layout, or whose grid the card
// cannot run, is refused as cudaErrorInvalidValue before any launch.
int wiser_dense_scan(const WiserDenseScanParams* p, void* stream) {
  using namespace wiser_dense;
  ScanArgs a;
  a.sc = (const float*)p->sc;
  a.tf = (const int32_t*)p->tf;
  a.tf8 = (const uint8_t*)p->tf8;
  a.code = (const uint8_t*)p->code;
  a.avg32 = (const float*)p->avg32;
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
  a.part_keys = (unsigned long long*)p->part_keys;
  a.rscratch = (unsigned long long*)p->rscratch;
  a.top_docs = (int32_t*)p->top_docs;
  a.top_score = (float*)p->top_score;
  a.top_tfs = (int32_t*)p->top_tfs;
  a.flags = (int32_t*)p->flags;
  const bool tc = a.tf8 != nullptr;
  const long long smem = tc ? scan_bytes<true>(a.T, a.KP)
                            : scan_bytes<false>(a.T, a.KP);
  const long long msmem = merge_bytes(a.KP);
  if (smem != p->smem || (a.nseg > 1 && msmem != p->merge_smem) ||
      a.K != a.M + 1 || a.K > a.KP || a.B > 65535 || a.nseg < 1 ||
      (a.nseg > 1 && !a.part_keys) ||
      keys_in_smem(a.KP) != (a.rscratch == nullptr) ||
      (long long)a.nseg * a.bps < a.nblk || a.N_pad % 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(tc ? launch_scan<true>(a, smem, msmem, s)
                  : launch_scan<false>(a, smem, msmem, s));
}

// Launch the pick on `stream` (no synchronize), one CTA a query.
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
  a.ub_scratch = (float*)p->ub_scratch;
  a.blk = (long long*)p->blk;
  a.next_ub = (float*)p->next_ub;
  const bool ub_smem = a.ub_scratch == nullptr;
  const long long smem = pick_bytes(a.T, a.NB, ub_smem);
  if (smem != p->smem || (ub_smem && 4 * a.NB > kUbSmemBytes) ||
      a.C < 1 || a.C + 1 > a.NB || (a.bm2 && !a.ap))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem(pick_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  pick_kernel<<<a.B, kPickThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* wiser_dense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
