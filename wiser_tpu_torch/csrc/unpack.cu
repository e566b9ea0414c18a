// Decode of bit-packed 128-value posting blocks for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel wiser_tpu/ops/unpack.py:_pallas_kernel
// (launched by _pallas_unpack, :123), and its XLA twin unpack_blocks_xla +
// delta_decode_docs, which the staged engine's packed cold transport runs
// in _make_doc_combine and unpack_doc_blocks runs once per width.
//
// Format: block g holds 128 values packed at a width w in 1..32; value i is
// bits [i*w, (i+1)*w) of a little-endian stream of 4*w uint32 words. Doc-id
// blocks store delta-1 of ascending ids with lane 0 stored as 0, against a
// per-block first id: ids = first + inclusive_prefix(d + 1) - (d_0 + 1).
//
// Bound: bytes. Per value the kernel reads w/32 words, writes one word and
// does a few integer operations in between, far below the card's ratio of
// operations to bytes. So the design keeps bytes in flight, the card busy
// from the first block to the last, and the instructions per block few
// (a column that fits in the 50 MB L2 decodes fast enough for the
// instruction rate to show):
//
// - One launch per column. A block table (width, word offset into one flat
//   stream, destination block, first id) lets one launch decode every
//   width of a doc column and write each block in place; the TPU kernel's
//   grid ran one width per call, in order on one core. The uniform entry
//   (the staged engine's w = 16 chunks) is the same kernel with the table
//   implied: width fixed, offset g*4w, destination g.
// - A persistent grid: as many CTAs as fit on the SMs at once, each warp
//   walking blocks in grid stride, so no CTA is launched or retired per
//   handful of blocks.
// - A ring of packed words in shared memory, kStages = 2 blocks deep per
//   warp: while a warp decodes block i, block i+1's words are in flight,
//   and the table row of block i+2 is loaded a block ahead. With up to 64
//   resident warps an SM then has ~64 blocks' words in flight, more than
//   the memory system needs; a deeper ring only added prologue work at the
//   staged engine's small G.
// - The ring is fed by 16-byte cp.async, one per lane below the width (a
//   block is 16*w bytes, one warp instruction), committed as one group per
//   block. The 1D TMA copy (cp.async.bulk with an mbarrier per stage) was
//   tried first: one bulk copy per 16..512-byte block, started by one lane,
//   plus the barrier's arming, init and a proxy fence, cost more than it
//   saved: at w = 16 and G <= 16,384 it ran slower than the per-lane copy
//   and than the simple kernel before it (one CTA per 8 blocks, no ring).
//
// Decode: each lane extracts 4 consecutive values, each one funnel shift of
// the two words it may span (the width is read per block, nothing is a
// compile-time constant); in delta mode the in-block inclusive prefix sum
// of (d + 1) is a 4-value serial sum per lane plus a warp shuffle scan; each
// lane writes its 4 int32 ids as one 16-byte store (512 coalesced bytes a
// warp).
//
// Arithmetic: sums run in uint32, which wraps exactly as the reference's
// int32 cumsum does; the funnel shift takes its amount mod 32 and the mask
// is 0xFFFFFFFF >> (32 - w), so no shift is out of range. Block and word
// indices are 64-bit: a 20M-doc column's output passes 2^31 bytes. A table
// entry out of range (width outside 1..32, an offset not a multiple of 4
// words or past the stream, a destination past the output) traps instead
// of reading or writing out of bounds.

#include <cstdint>
#include <cuda_runtime.h>

namespace wiser {

constexpr int kBlock = 128;
constexpr int kWarps = 8;         // warps per CTA
constexpr int kStages = 2;        // ring depth per warp (a power of 2)
constexpr int kMaxWords = 128;    // 4 * 32: a block at w = 32

// The block table of the mixed entry; the uniform entry leaves the
// pointers null and every block has `uniform_width`, offset g * 4 * width
// and destination g.
struct Table {
  const uint8_t* width;
  const long long* offset;  // in uint32 words, a multiple of 4
  const int32_t* dest;
  const int32_t* first;  // nullptr: raw values, no delta decode
  int uniform_width;
};

// A block's entry; lane 0 keeps the staged block's in its slot.
struct __align__(16) Entry {
  long long dest;
  int width;
  int32_t first;
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <bool kDelta, bool kTable>
__global__ void __launch_bounds__(kWarps * 32)
unpack_kernel(const uint32_t* __restrict__ words, long long n_words, Table t,
              int32_t* __restrict__ out, long long n_blocks,
              long long n_out_blocks) {
  // +4 words a slot: the decode reads the word past a value's own, which
  // the mask then drops, without a branch; slots stay 16-byte aligned
  __shared__ __align__(16) uint32_t ring[kWarps][kStages][kMaxWords + 4];
  __shared__ Entry slot[kWarps][kStages];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  const long long g0 = (long long)blockIdx.x * kWarps + warp;
  if (g0 >= n_blocks) return;  // uniform across the warp
  const int n_mine = (int)((n_blocks - 1 - g0) / stride) + 1;

  // What this warp's i-th block needs from memory before its copy: its
  // table row (kTable) and its first id. Loaded a block ahead.
  struct Row {
    long long offset, dest;
    int width;
    int32_t first;
  };
  auto fetch = [&](int i) {
    Row r{0, 0, 1, 0};
    if (i < n_mine) {
      const long long gi = g0 + (long long)i * stride;
      if (kTable) {
        r.width = __ldg(t.width + gi);
        r.offset = __ldg(t.offset + gi);
        r.dest = __ldg(t.dest + gi);
      }
      if (kDelta) r.first = __ldg(t.first + gi);
    }
    return r;
  };
  // Stage the i-th block into slot i % kStages: lanes below the width copy
  // 16 bytes each, lane 0 keeps the entry. Every call commits one cp.async
  // group, empty or not, so that group i is block i's.
  auto stage_in = [&](int i, const Row& r) {
    if (i < n_mine) {
      Entry e;
      long long offset;
      if (kTable) {
        if (r.width < 1 || r.width > 32 || (r.offset & 3) || r.offset < 0 ||
            r.offset + 4 * r.width > n_words || r.dest < 0 ||
            r.dest >= n_out_blocks)
          __trap();
        e.width = r.width;
        e.dest = r.dest;
        offset = r.offset;
      } else {
        e.width = t.uniform_width;
        e.dest = g0 + (long long)i * stride;
        offset = e.dest * 4 * e.width;
      }
      e.first = r.first;
      const int s = i & (kStages - 1);
      if (lane < e.width)
        cp_async16(static_cast<uint32_t>(__cvta_generic_to_shared(
                       &ring[warp][s][4 * lane])),
                   words + offset + 4 * lane);
      if (lane == 0) slot[warp][s] = e;
    }
    cp_async_commit();
  };

  Row ahead;
  {
    Row r[kStages + 1];  // every load in flight before the first copy
#pragma unroll
    for (int i = 0; i <= kStages; ++i) r[i] = fetch(i);
#pragma unroll
    for (int i = 0; i < kStages; ++i) stage_in(i, r[i]);
    ahead = r[kStages];
  }

  for (int i = 0; i < n_mine; ++i) {
    const int s = i & (kStages - 1);
    // groups complete in order: at most kStages - 1 pending means block
    // i's has landed; the warp barrier shows every lane's copy to all
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    const Entry e = slot[warp][s];
    const uint32_t* sw = ring[warp][s];
    const uint32_t mask = 0xFFFFFFFFu >> (32 - e.width);
    uint32_t v[4];
    int bit = lane * 4 * e.width;
#pragma unroll
    for (int j = 0; j < 4; ++j, bit += e.width)
      v[j] = __funnelshift_r(sw[bit >> 5], sw[(bit >> 5) + 1], bit & 31) &
             mask;
    __syncwarp();  // every lane has read slot s before it is refilled
    stage_in(i + kStages, ahead);
    ahead = fetch(i + kStages + 1);

    if (kDelta) {
      const uint32_t s0 = v[0] + 1u;
      const uint32_t s1 = s0 + v[1] + 1u;
      const uint32_t s2 = s1 + v[2] + 1u;
      const uint32_t s3 = s2 + v[3] + 1u;
      uint32_t run = s3;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, run, d);
        if (lane >= d) run += y;
      }
      const uint32_t d0p1 = __shfl_sync(0xFFFFFFFFu, s0, 0);
      const uint32_t base = (uint32_t)e.first + (run - s3) - d0p1;
      v[0] = base + s0;
      v[1] = base + s1;
      v[2] = base + s2;
      v[3] = base + s3;
    }
    reinterpret_cast<int4*>(out + e.dest * kBlock)[lane] =
        make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  }
}

// CTAs of the persistent grid per device and instantiation (0: not yet
// queried).
int g_max_ctas[64][3];

template <bool kDelta, bool kTable>
int launch(const uint32_t* words, long long n_words, const Table& t,
           int32_t* out, long long n_blocks, long long n_out_blocks,
           cudaStream_t stream) {
  if (n_blocks == 0) return (int)cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  int& ctas = g_max_ctas[dev][kTable ? 2 : kDelta];
  if (ctas == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, unpack_kernel<kDelta, kTable>, kWarps * 32, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    ctas = sms * per_sm;
  }
  const long long needed = (n_blocks + kWarps - 1) / kWarps;
  const unsigned grid = (unsigned)(needed < ctas ? needed : ctas);
  unpack_kernel<kDelta, kTable><<<grid, kWarps * 32, 0, stream>>>(
      words, n_words, t, out, n_blocks, n_out_blocks);
  return (int)cudaGetLastError();
}

}  // namespace wiser

// words: n_blocks * 4 * width uint32, 16-byte aligned; first: n_blocks int32
// or NULL (NULL writes the raw unpacked values); out: n_blocks * 128 int32,
// 16-byte aligned. Launches on `stream` and returns the cudaError_t of the
// launch.
extern "C" int wiser_unpack_delta_blocks(const void* words, const void* first,
                                         void* out, long long n_blocks,
                                         int width, void* stream) {
  if (width < 1 || width > 32 || n_blocks < 0) return (int)cudaErrorInvalidValue;
  const wiser::Table t{nullptr, nullptr, nullptr,
                       static_cast<const int32_t*>(first), width};
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<int32_t*>(out);
  const long long n_words = n_blocks * 4 * width;
  auto s = static_cast<cudaStream_t>(stream);
  return first != nullptr
             ? wiser::launch<true, false>(w, n_words, t, o, n_blocks, n_blocks, s)
             : wiser::launch<false, false>(w, n_words, t, o, n_blocks, n_blocks,
                                           s);
}

// One launch over a packed column of mixed widths. words: n_words uint32,
// 16-byte aligned; per table entry k < n_blocks: width[k] (uint8, 1..32),
// offset[k] (int64 word offset of its 4*width words, a multiple of 4),
// dest[k] (int32 block of `out` it decodes into, < n_out_blocks), first[k]
// (int32). out: n_out_blocks * 128 int32, 16-byte aligned.
extern "C" int wiser_unpack_mixed_blocks(const void* words, long long n_words,
                                         const void* width, const void* offset,
                                         const void* dest, const void* first,
                                         void* out, long long n_blocks,
                                         long long n_out_blocks, void* stream) {
  if (n_blocks < 0 || n_words < 0 || first == nullptr)
    return (int)cudaErrorInvalidValue;
  const wiser::Table t{static_cast<const uint8_t*>(width),
                       static_cast<const long long*>(offset),
                       static_cast<const int32_t*>(dest),
                       static_cast<const int32_t*>(first), 0};
  return wiser::launch<true, true>(static_cast<const uint32_t*>(words), n_words, t,
                             static_cast<int32_t*>(out), n_blocks,
                             n_out_blocks, static_cast<cudaStream_t>(stream));
}

extern "C" const char* wiser_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
