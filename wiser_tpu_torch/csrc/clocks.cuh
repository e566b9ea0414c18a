// Phase marks for a measuring build (-DWISER_CLOCKS; never the library
// the entry points load): thread 0 of every CTA adds the cycles between
// marks to its phase's counter (WCLK), or one to a count (WCLK_COUNT).
// Include it inside the library's namespace; WISER_CLOCKS_READER(fn)
// defines the extern "C" reader `int fn(unsigned long long* out)` that
// copies the 32 counters out and zeroes them (cudaErrorNotSupported in
// the library the entry points load). tools/dense_bench.clocks_build
// makes the build and read_clocks / phase_split read it.

#pragma once

#ifdef WISER_CLOCKS
__device__ unsigned long long g_clk[32];
#define WCLK_START long long clk_t = clock64();
#define WCLK(i)                                                  \
  do {                                                           \
    if (threadIdx.x == 0) {                                      \
      const long long clk_n = clock64();                         \
      atomicAdd(&g_clk[i], (unsigned long long)(clk_n - clk_t)); \
      clk_t = clk_n;                                             \
    }                                                            \
  } while (0)
#define WCLK_COUNT(i) \
  if (threadIdx.x == 0) atomicAdd(&g_clk[i], 1ull)
#define WISER_CLOCKS_READER(fn, ns)                                     \
  extern "C" int fn(unsigned long long* out) {                          \
    cudaError_t err =                                                   \
        cudaMemcpyFromSymbol(out, ns::g_clk, sizeof(ns::g_clk));        \
    if (err != cudaSuccess) return (int)err;                            \
    static const unsigned long long zero[32] = {};                      \
    return (int)cudaMemcpyToSymbol(ns::g_clk, zero, sizeof(zero));      \
  }
#else
#define WCLK_START
#define WCLK(i) \
  do {          \
  } while (0)
#define WCLK_COUNT(i)
#define WISER_CLOCKS_READER(fn, ns)                                     \
  extern "C" int fn(unsigned long long* out) {                          \
    (void)out;                                                          \
    return (int)cudaErrorNotSupported;                                  \
  }
#endif
