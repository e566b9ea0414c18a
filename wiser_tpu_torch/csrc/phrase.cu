// The phrase steps for Hopper (sm_90a). This file holds the position
// verification that the mega phrase routes end in.
//
// Replaces wiser_tpu/engine/kernels.py:1291 _verify_pos_windows
// (XLA-compiled jnp, not Pallas), which the pruned mega phrase (:1540)
// and the full mega phrase (:1737) call (the compact route, :757, and
// the semidense phrase route, :938, verify in phrase_route.cu). Its
// eager torch form (engine/kernels.py _verify_pos_windows_torch, the
// plain version) builds a
// (B, T, NL, PW) window gather and, per term, a (B, NL, PP, PW) compare
// plane that it reduces with .any(): most of a mega phrase group's device
// time and all of its peak memory.
//
// What it computes, per (query b, lane) of B x NL:
//   - each term t's bag is the window of PW positions from its start
//     ps[b, t, lane], clamped to [0, n - PW] as dynamic_slice clamps it
//     (the engine pads the positions column with POS_PAD >= PW entries, so
//     a real window is never clamped), each read clamped into the column;
//     entry j is valid while j < pe - ps;
//   - the bases are the anchor term's first PP valid positions minus the
//     anchor (anchor[b], a query term);
//   - a base y counts when every term t holds y + t among its valid
//     entries (the anchor's own test holds by construction);
//   - out[b, lane] = the number of bases that count (int32).
// Positions are uint16 stored as int16 bits (read & 0xFFFF, so the 65535
// pad stays 65535) or int32 (a column past 2^16; its pad is -1).
//
// Bound: bytes. The least the step must move is what it is given (the
// kept docs and the runs), each (lane, term)'s pos_starts pair, the
// posting-id sectors a recovery must touch, the distinct 32-byte sectors
// of each window's valid entries, and the (B, NL) counts
// (tools/semidense_bench.docs_bound_bytes).
// The compares are integer work on data in shared memory.
//
// Design (group_kernel): the routes pass what they hold, not bag bounds:
// the kept docs (the full-scan and block-pruned mega routes). For each
// kept doc, each query term t's posting index in its run [starts[b, t],
// ends[b, t]) is recovered inside the kernel, as the plain version's
// fixed-count search (engine/kernels._binary_search, n_iters halvings)
// finds it: by bound.cuh's G-ary lower bound (G - 1 pivots a round, one
// ballot, ~log_G of the run's ids dependent reads where the search takes
// log2) wherever that search has converged and the doc lies in the run
// (bound.cuh recover), and elsewhere by that search itself, replayed by
// the term's thread (search_fixed); the bag bounds are then read from
// pos_starts (clamped into the column) and the window verification runs
// against the query's own anchor term. This replaces a torch search of
// n_iters launches of ~6 elementwise and gather ops, and the two gathers
// of pos_starts, before the launch.
// An item takes G threads, the work its windows need: G = 8 where T <= 8
// and PW <= 32 (the engine's phrase groups), four items a warp, so four
// times the items are in flight that a warp an item allows; G = 32
// otherwise. Thread t < T of the group reads term t's bounds; verify.cuh's
// warp_count with G lanes (which phrase_route.cu's semidense phrase finish
// calls with a warp) copies each term's valid entries, and only those,
// into the group's shared-memory windows (T x PW int32); then each thread
// takes bases i = lane, lane + G, ... and scans the other terms' windows
// for y + t, stopping at the first hit and at the first term that misses;
// a group sum gives the count. Nothing the size of the compare planes
// reaches device memory. The bags are not searched by sorted order: the
// compare over the valid entries needs no order, and a term's bag is short
// (its tf) on every row the engine verifies.

#include <cstdint>
#include <cuda_runtime.h>

#include "bound.cuh"
#include "verify.cuh"

namespace wiser_phrase {

constexpr int kMaxT = 32;  // terms: one thread a term reads its bounds
constexpr int kGroupMaxT = 8;    // an 8-thread group's terms at most
constexpr int kGroupMaxPW = 32;  // and its window

__device__ __forceinline__ long long clampll(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The mega routes' arguments.
struct GroupArgs {
  const void* positions;  // (n,) int16 bits of uint16, or int32
  long long n;
  const int32_t* pos_starts;  // (n_ps,) bag starts by posting index
  long long n_ps;
  const int32_t* doc;     // (n_doc,) posting doc ids
  long long n_doc;
  const int32_t* docs;    // (B, NL) kept docs
  const int32_t* starts;  // (B, T) runs, query-term order
  const int32_t* ends;
  const int32_t* anchor;  // (B,)
  int32_t* out;           // (B, NL)
  int B, T, NL, PP, PW, n_iters;
};

// A group of G threads a (query, lane) item, 32 / G items a warp, W warps
// a CTA: each term's posting index recovered, its bag bounds from
// pos_starts, the verification.
template <bool kU16, int G>
__global__ void __launch_bounds__(256) group_kernel(GroupArgs a) {
  extern __shared__ __align__(16) int gsmem[];
  const int W = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const int gid = l32 / G, gl = l32 % G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (gid * G);
  const int per_warp = 32 / G;
  const long long item =
      ((long long)blockIdx.x * W + wid) * per_warp + gid;
  if (item >= (long long)a.B * a.NL) return;  // the group alone
  const int T = a.T;
  const int b = (int)(item / a.NL);
  // thread t < T: query term t's posting index
  int p = 0;
  const int anchor = a.anchor[b];
  const int target = a.docs[item];
  const int32_t* st = a.starts + (long long)b * T;
  const int32_t* en = a.ends + (long long)b * T;
  bool replay = false;
  for (int t = 0; t < T; ++t) {
    const int r = wiser_bound::recover<G>(a.doc, a.n_doc, target, st[t],
                                          en[t], a.n_iters, gl, gmask);
    if (gl == t) {
      p = r;
      replay = r < 0;
    }
  }
  if (replay)
    p = wiser_bound::search_fixed<0>(a.doc, a.n_doc, target, st[gl], en[gl],
                                     a.n_iters);
  long long s = 0, e = 0;
  if (gl < T) {
    // pos_starts[p], pos_starts[p + 1], each index clamped into the
    // column (p + 1 in int32, as the plain version adds it)
    s = a.pos_starts[clampll(p, 0, a.n_ps - 1)];
    e = a.pos_starts[clampll((int)((unsigned)p + 1u), 0, a.n_ps - 1)];
  }
  const long long items_before =
      (long long)wid * per_warp + gid;  // this group's windows in the CTA
  const int count = wiser_verify::warp_count<kU16, G>(
      a.positions, a.n, s, e, T, a.PP, a.PW, anchor,
      gsmem + items_before * wiser_verify::warp_ints(T, a.PW), gl, gmask);
  if (gl == 0) a.out[item] = count;
}

template <bool kU16, int G>
cudaError_t launch_group(const GroupArgs& a, int W, size_t smem,
                         cudaStream_t s) {
  if (smem > (48u << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        group_kernel<kU16, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long items = (long long)a.B * a.NL;
  const long long per_cta = (long long)W * (32 / G);
  const unsigned grid = (unsigned)((items + per_cta - 1) / per_cta);
  group_kernel<kU16, G><<<grid, W * 32, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace wiser_phrase

extern "C" {

// ops/phrase._GroupParams: every field 8 bytes.
struct WiserVerifyGroupParams {
  long long positions, n, u16, pos_starts, n_ps, doc, n_doc;
  long long docs, starts, ends, anchor, out;
  long long B, T, NL, PP, PW, n_iters, G, W, smem;
};

// The verification from kept docs on `stream` (no synchronize), a group
// of G threads an item.
// Returns the launch error (0 on success); a plan whose shared bytes
// disagree with this file's layout, a group size other than 8 or 32, or
// a group of 8 past its T or PW, is refused as cudaErrorInvalidValue.
int wiser_phrase_verify_group(const WiserVerifyGroupParams* p, void* stream) {
  using namespace wiser_phrase;
  GroupArgs a;
  a.positions = (const void*)p->positions;
  a.n = p->n;
  a.pos_starts = (const int32_t*)p->pos_starts;
  a.n_ps = p->n_ps;
  a.doc = (const int32_t*)p->doc;
  a.n_doc = p->n_doc;
  a.docs = (const int32_t*)p->docs;
  a.starts = (const int32_t*)p->starts;
  a.ends = (const int32_t*)p->ends;
  a.anchor = (const int32_t*)p->anchor;
  a.out = (int32_t*)p->out;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.NL = (int)p->NL;
  a.PP = (int)p->PP;
  a.PW = (int)p->PW;
  a.n_iters = (int)p->n_iters;
  const int G = (int)p->G, W = (int)p->W;
  const long long smem = (long long)W * (32 / (G > 0 ? G : 32)) *
                         wiser_verify::warp_ints(a.T, a.PW) * 4;
  if (a.T < 1 || a.T > kMaxT || a.T > G || a.PW < 1 || a.PP < 1 ||
      a.n < 1 || a.n_ps < 1 || W < 1 || W > 8 || smem != p->smem ||
      (G != 8 && G != 32) ||
      (G == 8 && (a.T > kGroupMaxT || a.PW > kGroupMaxPW)) ||
      !a.doc || a.n_doc < 1 || !a.docs || !a.starts || !a.ends ||
      !a.anchor)
    return (int)cudaErrorInvalidValue;
  if ((long long)a.B * a.NL == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool u16 = p->u16 != 0;
  cudaError_t err;
  if (G == 8) {
    err = u16 ? launch_group<true, 8>(a, W, smem, s)
              : launch_group<false, 8>(a, W, smem, s);
  } else {
    err = u16 ? launch_group<true, 32>(a, W, smem, s)
              : launch_group<false, 32>(a, W, smem, s);
  }
  return (int)err;
}

const char* wiser_phrase_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
