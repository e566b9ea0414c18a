// The batched conjunctive search step (bs) for Hopper (sm_90a).
//
// Replaces wiser_tpu/engine/kernels.py:205 search_body, with _candidates
// (:176), _binary_search (:155), boundary_truncated (:188) and
// two_level_top_m (:284): XLA-compiled jnp, not Pallas. XLA fused that step
// on the TPU; its eager torch form (engine/kernels.py search_body_torch, the
// plain version) runs a hundred launches a group.
//
// What it computes, per query b of a group of B (raw or tc columns):
//   - slot 0's run [starts[b,0], ends[b,0]) loaded into L lanes from a
//     start clamped to [0, n - L] (dynamic_slice's clamp); lanes past the
//     run are invalid;
//   - each valid lane's doc searched (lower bound, at most n_bs_iters
//     halvings) in the runs of slots 1..T-1; a lane is matched when every
//     slot holds the doc;
//   - its f32 score: raw cscore * use[0] + (p_1 + p_2 + ...) with
//     p_t = score[lo_t] * use[t], the sum sequential in slot order; with
//     T == 1 the candidate score alone; tc: tc_score(lane, idf[t], avg) of
//     each slot, the others summed first and then added to the
//     candidate's. Unmatched and invalid lanes score -inf;
//   - the top M lanes by (score desc, lane asc), which is lax.top_k's
//     tie order (lane order is doc order); FLAG_TRUNC when the M-th score
//     is > -inf and the (M+1)-th equals it (boundary_truncated);
//     FLAG_TF_SAT (tc) when a kept lane of any slot has a saturated tf
//     byte;
//   - the winners' docs (-1 where not kept), scores, per-slot posting
//     indices (cs + lane in slot 0, the search's lo in the others) and
//     tfs (0 where not kept).
//
// Bound: bytes. The least the step must move is each byte once: the
// candidate slice (8 bytes a lane raw, 6 tc), per other slot its run or
// one 4-byte doc id per probe of each valid lane, whichever is fewer, and
// (2T + 2) * M + 1 output words (tools/search_bench.bound_bytes). There
// are no operations to speak of. The first form of this kernel (the
// plane path below) ran at 3-11% of that bound: one thread per lane made
// T-1 binary searches of dependent global loads (1), a (B, L) f32 score
// plane went to device memory and was read back up to ten times by a
// per-query radix select (2) whose digit scan ran on one thread between
// barriers (3), and the winners re-ran their searches for the posting
// indices (4). This form answers each:
//
// - The tile path (M + 1 <= kKeyCap keys, every engine group). A worker
//   (a warp where L <= 128, else a CTA of 256 threads) takes one query's
//   tiles of TL consecutive candidate lanes (TL = 128 for a warp, 256 to
//   1,024 for a CTA; each thread holds LPT lanes, loads coalesced; the
//   next tile's candidate docs are staged into shared memory by cp.async
//   a tile ahead). The step waits on memory and barriers, so registers
//   are capped for four CTAs an SM.
// - (1) Per tile and slot, in slot order, over the live lanes (min and
//   max doc, not the first and last lane: a clamped slice near the
//   column's end crosses into another run, unsorted): the window of the
//   run starts at the lower bound of min. It is the slot's cursor (the
//   last tile's window end) where this tile's live docs all pass the last
//   tile's, as they do in sorted tiles, so the run streams on with no
//   search; else one warp finds it in about log32(run) rounds of 31
//   probes in flight, instead of a chain of log2(run) loads per lane. The
//   run then streams through shared memory in chunks (cp.async into three
//   buffers, one chunk read ahead, one barrier a chunk; a cursor's first
//   chunk goes out before the slot's first barrier) until a chunk passes
//   max, and each lane whose lower bound lies in a chunk finds it there
//   by binary lifting of a fixed depth over the padded chunk (a warp skips
//   the lane slots none of its lanes needs). Past a budget of what the
//   live lanes' own searches would move (a 32-byte sector a probe), the
//   rest of the run is searched per lane in device memory. Lanes that
//   miss a slot drop out; a found lane's payload load goes out at once
//   and is added a barrier later, in slot order. Where a slot's run is
//   longer than 2^n_bs_iters - 1 (or lies outside the column), the bounded
//   loop may stop short of the lower bound, and `found` and `lo` must
//   still equal it: that slot keeps the first form's bounded per-lane
//   search.
// - (2) No plane: each tile's matched lanes become 64-bit keys (ordered
//   score bits above the inverted lane and a bit that keeps -0); those
//   above the running K-th key are compacted into shared memory (one
//   atomic a warp), put in order there (by rank where a thread can hold
//   each key, else by a bitonic sort), and the tile's top K = min(M + 1,
//   L) is merged by rank into the worker's running top K (KP = the power
//   of 2 >= K keys, two lists that swap). Keys are unique, so ties fall to
//   the lowest lane. A query with more tiles than its worker takes (the
//   wrapper splits the tiles of a narrow group across nseg CTAs to fill
//   the card) leaves nseg lists of K (key, source) pairs, which one short
//   second launch merges per query.
// - (3) Every sort and merge step is spread over the worker's threads;
//   nothing runs on one thread between barriers but the cursor and the
//   flag word.
// - (4) Each kept key carries its source: the tile's lower bounds stay in
//   shared memory (one tile) or are written for the tile's top K only
//   (several tiles), so the winners gather tfs and posting indices
//   without a second search.
// - One launch a group where L fits one tile or the group is wide enough
//   to fill the card, two otherwise.
// On an H100 this form runs at 12-23% of the bound at the engine's bs
// shapes, 1.4-5.4x faster than the first form (PERF.md); what remains is
// each slot's chain of a window round trip and a few barriers a tile.
//
// The plane path (M + 1 > kKeyCap, the check grid's M = L cases): the
// first form's two launches, a score plane and a per-query radix select
// with a bitonic sort, kept as they were for those calls only.
//
// Arithmetic: every f32 operation is an explicit round-to-nearest
// intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn: never contracted into an FMA,
// never an approximate division), and the library is built with
// -fmad=false besides, so the scores equal the plain version's bit for
// bit. Searches compute mid as lo + ((hi - lo) >> 1) in 64 bits; offsets
// into the columns, the plane, the scratch and the outputs are 64-bit.
// Gathers clamp their index into the column as the plain version's
// _gather1d does. The keys, the tc decode and the top-K sort and merge
// live in keys.cuh, shared with dense.cu; the tile and plane paths live in
// tile.cuh, the warp's 32-ary lower bound in bound.cuh.

#define WISER_TILE_NS wiser_search
#include "tile.cuh"

extern "C" {

// The bs step on `stream` (tile.cuh launch).
int wiser_bs_search(const WiserStepParams* p, void* stream) {
  return wiser_search::launch(p, stream);
}

const char* wiser_search_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
