// Fused decode of bit-packed 128-value posting blocks for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel wiser_tpu/ops/unpack.py:_pallas_kernel
// (and its XLA twin unpack_blocks_xla + delta_decode_docs, which the staged
// engine's packed cold transport runs in _make_doc_combine).
//
// Format: block g holds 128 values packed at a width w in 1..32; value i is
// bits [i*w, (i+1)*w) of a little-endian stream of 4*w uint32 words. Doc-id
// blocks store delta-1 of ascending ids with lane 0 stored as 0, against a
// per-block first id.
//
// One warp decodes one block. The warp copies the block's 4*w words into
// shared memory (coalesced), each lane extracts 4 consecutive values with
// per-lane shift amounts (the width is a runtime argument, so nothing is a
// compile-time constant as it was on the TPU), and in delta mode the
// in-block inclusive prefix sum of (d + 1) is a 4-value serial sum per lane
// plus a warp shuffle scan across lanes. Each lane writes its 4 int32 ids as
// one 16-byte store straight into the scratch doc column.
//
// Bound: bytes. Per value the kernel reads w/32 words and writes one word, a
// few integer operations in between, so it is far below the card's ratio of
// operations to bytes; the design keeps every read and write coalesced and
// touches each byte once. No TMA and no pipelining yet: simple and right
// first.
//
// Arithmetic: sums run in uint32, which wraps exactly as the reference's
// int32 cumsum does; out-of-range shifts (x << 32, x >> 32) are undefined in
// CUDA, so the high word is read only when the value straddles a word
// (then 1 <= 32 - off <= 31) and the w = 32 mask is written out in full.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kWarpsPerCta = 8;

__global__ void __launch_bounds__(kWarpsPerCta * 32)
unpack_delta_kernel(const uint32_t* __restrict__ words,
                    const int32_t* __restrict__ first,
                    int32_t* __restrict__ out, long long n_blocks,
                    int width) {
  __shared__ uint32_t smem[kWarpsPerCta][kBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * kWarpsPerCta + warp;
  if (g >= n_blocks) return;  // uniform across the warp

  const int n_words = 4 * width;
  const uint32_t* src = words + g * n_words;
  uint32_t* sw = smem[warp];
  for (int i = lane; i < n_words; i += 32) sw[i] = src[i];
  __syncwarp();

  const uint32_t mask = width == 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bit = (lane * 4 + j) * width;
    const int w0 = bit >> 5;
    const int off = bit & 31;
    uint32_t x = sw[w0] >> off;
    if (off + width > 32) {
      const int w1 = min(w0 + 1, n_words - 1);
      x |= sw[w1] << (32 - off);
    }
    v[j] = x & mask;
  }

  if (first != nullptr) {
    // ids = first + inclusive_prefix(d + 1) - (d_0 + 1)
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
    const uint32_t base = (uint32_t)first[g] + (run - s3) - d0p1;
    v[0] = base + s0;
    v[1] = base + s1;
    v[2] = base + s2;
    v[3] = base + s3;
  }
  reinterpret_cast<int4*>(out + g * kBlock)[lane] =
      make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
}

}  // namespace

// words: n_blocks * 4 * width uint32; first: n_blocks int32 or NULL (NULL
// writes the raw unpacked values); out: n_blocks * 128 int32, 16-byte
// aligned. Launches on `stream` and returns the cudaError_t of the launch.
extern "C" int wiser_unpack_delta_blocks(const void* words, const void* first,
                                         void* out, long long n_blocks,
                                         int width, void* stream) {
  if (width < 1 || width > 32 || n_blocks < 0) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0) return (int)cudaSuccess;
  const long long grid = (n_blocks + kWarpsPerCta - 1) / kWarpsPerCta;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  unpack_delta_kernel<<<(unsigned)grid, kWarpsPerCta * 32, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(first),
      static_cast<int32_t*>(out), n_blocks, width);
  return (int)cudaGetLastError();
}

extern "C" const char* wiser_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
