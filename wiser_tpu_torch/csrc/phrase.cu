// The phrase steps for Hopper (sm_90a). This file holds the position
// verification that every resident phrase route ends in.
//
// Replaces wiser_tpu/engine/kernels.py:1291 _verify_pos_windows
// (XLA-compiled jnp, not Pallas), which the compact route (:757), the
// semidense phrase route (:938), the pruned mega phrase (:1540) and the
// full mega phrase (:1737) call. Its eager torch form
// (engine/kernels.py _verify_pos_windows_torch, the plain version) builds a
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
//     anchor (anchor[b]: 0 on the compact and semidense routes, a query
//     term on the mega routes);
//   - a base y counts when every term t holds y + t among its valid
//     entries (the anchor's own test holds by construction);
//   - out[b, lane] = the number of bases that count (int32).
// Positions are uint16 stored as int16 bits (read & 0xFFFF, so the 65535
// pad stays 65535) or int32 (a column past 2^16; its pad is -1).
//
// Bound: bytes. The least the step must move is ps and pe (4 bytes each a
// (query, term, lane)), the distinct 32-byte sectors of each (lane, term)
// window's valid entries, the anchor row and the (B, NL) counts
// (tools/semidense_bench.verify_bound_bytes). The compares are integer
// work on data in shared memory.
//
// Design: one warp a (query, lane), W warps a CTA (ops/phrase.plan: as
// many as fit VERIFY_SMEM together). Thread t < T reads term t's bounds;
// verify.cuh's warp_count (which phrase_route.cu's finish kernels call
// too) copies each term's valid entries, and only those, into its
// shared-memory windows (T x PW int32, at most 32 KB a warp at T 8 and
// PW 1,024); then each thread takes bases i = l32, l32 + 32, ... and
// scans the other terms' windows for y + t, stopping at the first hit
// and at the first term that misses; a warp sum gives the count. Nothing
// the size of the compare planes reaches device memory. The bags are not
// searched by sorted order: the compare over the valid entries needs no
// order, and a term's bag is short (its tf) on every row the engine
// verifies.

#include <cstdint>
#include <cuda_runtime.h>

#include "verify.cuh"

namespace wiser_phrase {

constexpr int kMaxT = 32;  // terms: one thread a term reads its bounds

struct VerifyArgs {
  const void* positions;  // (n,) int16 bits of uint16, or int32
  long long n;
  const int32_t* ps;      // (B, T, NL)
  const int32_t* pe;      // (B, T, NL)
  const int32_t* anchor;  // (B,)
  int32_t* out;           // (B, NL)
  int B, T, NL, PP, PW;
};

template <bool kU16>
__global__ void __launch_bounds__(256) verify_kernel(VerifyArgs a) {
  extern __shared__ __align__(16) int smem[];
  const int W = blockDim.x >> 5;
  const int wid = threadIdx.x >> 5, l32 = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * W + wid;
  if (item >= (long long)a.B * a.NL) return;  // the warp alone
  const int T = a.T;
  const int b = (int)(item / a.NL);
  const int lane = (int)(item % a.NL);
  long long s = 0, e = 0;
  if (l32 < T) {
    const long long o = ((long long)b * T + l32) * a.NL + lane;
    s = a.ps[o];
    e = a.pe[o];
  }
  const int count = wiser_verify::warp_count<kU16>(
      a.positions, a.n, s, e, T, a.PP, a.PW, a.anchor[b],
      smem + (long long)wid * wiser_verify::warp_ints(T, a.PW), l32);
  if (l32 == 0) a.out[item] = count;
}

template <bool kU16>
cudaError_t launch_verify(const VerifyArgs& a, int W, size_t smem,
                          cudaStream_t s) {
  if (smem > (48u << 10)) {
    const cudaError_t err = cudaFuncSetAttribute(
        verify_kernel<kU16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long items = (long long)a.B * a.NL;
  const unsigned grid = (unsigned)((items + W - 1) / W);
  verify_kernel<kU16><<<grid, W * 32, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace wiser_phrase

extern "C" {

// ops/phrase._VerifyParams: every field 8 bytes.
struct WiserVerifyParams {
  long long positions, n, u16, ps, pe, anchor, out;
  long long B, T, NL, PP, PW, W, smem;
};

// The verification on `stream` (no synchronize). Returns the launch error
// (0 on success); a plan whose shared bytes disagree with this file's
// layout, or T past kMaxT, is refused as cudaErrorInvalidValue.
int wiser_phrase_verify(const WiserVerifyParams* p, void* stream) {
  using namespace wiser_phrase;
  VerifyArgs a;
  a.positions = (const void*)p->positions;
  a.n = p->n;
  a.ps = (const int32_t*)p->ps;
  a.pe = (const int32_t*)p->pe;
  a.anchor = (const int32_t*)p->anchor;
  a.out = (int32_t*)p->out;
  a.B = (int)p->B;
  a.T = (int)p->T;
  a.NL = (int)p->NL;
  a.PP = (int)p->PP;
  a.PW = (int)p->PW;
  const int W = (int)p->W;
  const long long smem = (long long)W * wiser_verify::warp_ints(a.T, a.PW) * 4;
  if (a.T < 1 || a.T > kMaxT || a.PW < 1 || a.PP < 1 || a.n < 1 || W < 1 ||
      W > 8 || smem != p->smem)
    return (int)cudaErrorInvalidValue;
  if ((long long)a.B * a.NL == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = p->u16 ? launch_verify<true>(a, W, smem, s)
                                 : launch_verify<false>(a, W, smem, s);
  return (int)err;
}

const char* wiser_phrase_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
