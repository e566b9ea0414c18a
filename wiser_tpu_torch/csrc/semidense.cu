// The semidense step (tail candidate x head others) for Hopper (sm_90a).
//
// Replaces wiser_tpu/engine/kernels.py:1103 make_semidense_kernel and :989
// make_semidense_kernel_tc (with _candidates, _binary_search, _dense_gather,
// two_level_top_m and boundary_truncated): XLA-compiled jnp, not Pallas.
// Its eager torch form (engine/kernels.py _semidense_step_torch, the plain
// version) writes some ten (B, L) planes a group: the candidate slice, a
// score, a match and a gathered row per dense slot, int64 index copies.
//
// What it computes, per query b of a group of B (raw or tc columns):
//   - every lane of slot 0's run (up to L lanes, the slice clamped as
//     dynamic_slice clamps it) is a candidate;
//   - slots 1..n_bs (short non-dense runs) are searched for it, a lower
//     bound of at most n_bs_iters halvings;
//   - every later slot is a dense other: one gather into its dense row
//     (slots[b, t]) at lane doc - doc_base (a mesh shard's first doc, 0
//     on one card), clamped into the row. raw: the f32 score, matched
//     where > 0; tc: the uint8 tf composed with the candidate lane's len
//     code, matched where the tf is > 0;
//   - a lane matches when it is a valid candidate, every searched slot
//     holds its doc and every dense slot's row does;
//   - its f32 score sums as s0 + (b1 + ... + bn) + d1 + d2 + ...: the
//     candidate's (raw: score * use[0]; tc: the table score), then the
//     searched slots' partials summed among themselves, then each dense
//     slot's in slot order;
//   - the exact top M by (score desc, lane asc) with the count-based
//     FLAG_TRUNC (K = min(M + 1, L) keys kept); tfs at the winners (raw:
//     postings_tf at the candidate index and at the searched slots' lower
//     bounds, dense_tf at the winner's lane; tc: the kept lanes' tf
//     bytes) and FLAG_TF_SAT where a kept lane's byte is 255.
//
// Bound: bytes. The least the step must move is the candidate slice (8
// bytes a lane raw, 6 tc), each searched slot's run once, the distinct
// 32-byte sectors of each dense row that the sorted candidate docs touch,
// and the outputs (tools/semidense_bench.semidense_bound_bytes). There are
// no operations to speak of. At the engine's group shapes (B 8 to 1,024,
// L 128 to 8,192) the bytes are a few microseconds of the card's memory
// rate; what the step waits on is the chain of dependent loads of a lane
// (candidate, search halvings, gathers) and the launch.
//
// Design (segsel.cuh): a query's lanes spread over nseg CTAs of 256
// threads, a thread a lane (four where a segment is longer than 256
// lanes), as many segments as keep a group within two CTAs an SM
// (ops/semidense.segments); each segment keeps its top K
// keys in select.cuh's shared-memory buffer, and the CTAs of a query, one
// thread-block cluster, merge them through distributed shared memory in
// the cluster's first CTA, which writes the outputs: one launch, no
// device-memory scratch. A searched slot is one lower bound a lane (the
// runs are short: non-dense terms), recomputed for the M winners' tfs.
// Past the K whose two lists fit shared memory with the step buffer, a
// query is one CTA (a deep k); past what shared memory holds at all, its
// buffer lies in device memory (the wrapper's scratch). tc scores come
// from the device table of dense.cu's tc_norm_kernel (ops/dense.tc_table,
// launched by the wrapper first), so no lane divides.
//
// Arithmetic: explicit round-to-nearest intrinsics and -fmad=false, so
// the scores equal the plain version's bit for bit.

#include "segsel.cuh"

namespace wiser_semidense {

using namespace wiser_segsel;

// the outputs (ops/semidense.semidense allocates them as one buffer)
struct StepOut {
  const int32_t* tf;        // raw: postings_tf
  long long n_tf;
  const int32_t* dense_tf;  // raw: (H, n_pad) int32 tf rows
  int M;
  int32_t* top_docs;   // (B, M)
  float* top_score;    // (B, M)
  int32_t* top_tfs;    // (B, T, M)
  int32_t* flags;      // (B,)
};

// The outputs of query b from its sorted keys R[0, K) (0 past the
// matched lanes), by the CTA: the winners' docs and scores, each slot's
// tf (a searched slot's at the winner's lower bound, found again), the
// flags.
template <bool TC>
__device__ __forceinline__ void write_outputs(const SelArgs& a,
                                              const StepOut& o, int b,
                                              const unsigned long long* R,
                                              int tid) {
  WCLK_START
  const int T = a.T, M = o.M, nb = a.nb;
  const int32_t* st = a.starts + (long long)b * T;
  const int32_t* en = a.ends + (long long)b * T;
  const long long cs = st[0];
  const long long s_doc = slice_start(cs, a.n_doc, a.L);
  const float ninf = -__int_as_float(0x7f800000);
  bool sat = false;
  for (int m = tid; m < M; m += kThreads) {
    const unsigned long long key = m < a.K ? R[m] : 0ull;
    const long long om = (long long)b * M + m;
    const bool kept = key != 0ull;
    const int lane = kept ? tile_key_lane(key) : 0;
    const int doc = kept ? __ldg(a.doc + s_doc + lane) : -1;
    o.top_score[om] = kept ? tile_key_score(key) : ninf;
    o.top_docs[om] = doc;
    for (int t = 0; t < T; ++t) {
      int tf = 0;
      if (kept) {
        if (t == 0) {
          if (TC) {
            tf = __ldg(a.tc + slice_start(cs, a.n_tc, a.L) + lane) & 0xFF;
          } else {
            tf = __ldg(o.tf + clampll(cs + lane, 0, o.n_tf - 1));
          }
        } else if (t < nb) {
          const long long lo =
              search_lower(a.doc, a.n_doc, a.n_iters, doc, st[t], en[t]);
          tf = TC ? __ldg(a.tc + clampll(lo, 0, a.n_tc - 1)) & 0xFF
                  : __ldg(o.tf + clampll(lo, 0, o.n_tf - 1));
        } else {
          const long long at =
              (long long)a.slots[(long long)b * T + t] * a.n_pad +
              clampll((long long)doc - a.doc_base, 0, a.n_pad - 1);
          tf = TC ? (int)__ldg(a.dense_tf8 + at) : __ldg(o.dense_tf + at);
        }
        if (TC) sat = sat || tf >= kTfSat;
      }
      o.top_tfs[((long long)b * T + t) * M + m] = tf;
    }
  }
  const int any_sat = __syncthreads_or(sat);
  if (tid == 0) {
    int f = 0;
    if (a.K > M) {
      const unsigned long long k0 = R[M - 1], k1 = R[M];
      const float s0 = k0 ? tile_key_score(k0) : ninf;
      const float s1 = k1 ? tile_key_score(k1) : ninf;
      if (s0 > ninf && s1 == s0) f |= kFlagTrunc;
    }
    if (any_sat) f |= kFlagTfSat;
    o.flags[b] = f;
  }
  WCLK(4);
  WCLK_COUNT(6);
}

// A CTA a (query, segment); the CTAs of a query one cluster. kSearch:
// some slot is searched (n_bs > 0). (No register bound: at 64 registers a
// thread, four CTAs an SM, ptxas spilled 40-48 bytes.)
template <bool TC, bool kSearch>
__global__ void __launch_bounds__(kThreads) step_kernel(SelArgs a,
                                                        StepOut o) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* X =
      a.xg ? a.xg + (long long)blockIdx.x * a.XC
           : reinterpret_cast<unsigned long long*>(smem + kHead);
  const int b = blockIdx.x / a.nseg, seg = blockIdx.x % a.nseg;
  const int tid = threadIdx.x;
  select_segment<TC, kSearch>(a, b, seg, X, smem, tid);
  const unsigned long long* R = merge_segments(a, X, seg, tid);
  if (R) write_outputs<TC>(a, o, b, R, tid);
}

}  // namespace wiser_semidense

extern "C" {

// ops/semidense._Params: every field 8 bytes.
struct WiserSemiParams {
  long long doc, n_doc, score, n_score, tf, n_tf, tc, n_tc;
  long long dense_sc, dense_tf, dense_tf8, n_pad, doc_base, norm_g;
  long long starts, ends, weights, slots;
  long long B, T, L, M, nb, n_iters, K, KP, XC, nseg, seg_lanes, xg, smem;
  long long top_docs, top_score, top_tfs, flags;
};

// The semidense step on `stream` (no synchronize): one launch. Returns
// the launch error (0 on success); a plan or argument set the kernel does
// not take is refused as cudaErrorInvalidValue before any launch.
int wiser_semidense_step(const WiserSemiParams* p, void* stream) {
  using namespace wiser_semidense;
  SelArgs a;
  a.doc = (const int32_t*)p->doc;
  a.n_doc = p->n_doc;
  a.score = (const float*)p->score;
  a.n_score = p->n_score;
  a.tc = (const uint16_t*)p->tc;
  a.n_tc = p->n_tc;
  a.dense_sc = (const float*)p->dense_sc;
  a.dense_tf8 = (const uint8_t*)p->dense_tf8;
  a.n_pad = p->n_pad;
  a.doc_base = p->doc_base;
  a.norm_g = (const float*)p->norm_g;
  a.starts = (const int32_t*)p->starts;
  a.ends = (const int32_t*)p->ends;
  a.weights = (const float*)p->weights;
  a.slots = (const int32_t*)p->slots;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.L = (int)p->L;
  a.nb = (int)p->nb;
  a.n_iters = (int)p->n_iters;
  a.K = (int)p->K;
  a.KP = (int)p->KP;
  a.XC = (int)p->XC;
  a.nseg = (int)p->nseg;
  a.seg_lanes = (int)p->seg_lanes;
  a.xg = (unsigned long long*)p->xg;
  StepOut o;
  o.tf = (const int32_t*)p->tf;
  o.n_tf = p->n_tf;
  o.dense_tf = (const int32_t*)p->dense_tf;
  o.M = (int)p->M;
  o.top_docs = (int32_t*)p->top_docs;
  o.top_score = (float*)p->top_score;
  o.top_tfs = (int32_t*)p->top_tfs;
  o.flags = (int32_t*)p->flags;
  const bool tc = a.tc != nullptr;
  if (!plan_ok(a) || a.XC != buffer_keys(a.KP) || o.M < 1 ||
      a.K != (o.M + 1 < a.L ? o.M + 1 : a.L) ||
      p->smem != sel_smem(a.XC, a.xg != nullptr) ||
      (tc ? !a.dense_tf8 || !a.norm_g
          : !a.dense_sc || !o.dense_tf || !a.score || !o.tf))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long sm = p->smem;
  if (a.nb > 1)
    return (int)(tc ? launch_segments(step_kernel<true, true>, a.B, a.nseg,
                                      sm, s, a, o)
                    : launch_segments(step_kernel<false, true>, a.B, a.nseg,
                                      sm, s, a, o));
  return (int)(tc ? launch_segments(step_kernel<true, false>, a.B, a.nseg,
                                    sm, s, a, o)
                  : launch_segments(step_kernel<false, false>, a.B, a.nseg,
                                    sm, s, a, o));
}

const char* wiser_semidense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

WISER_CLOCKS_READER(wiser_semidense_clocks, wiser_segsel)
