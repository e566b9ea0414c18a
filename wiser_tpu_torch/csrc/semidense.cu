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
//     FLAG_TRUNC (M + 1 keys kept); tfs at the winners (raw: postings_tf
//     at the candidate index and at the searched slots' lower bounds,
//     dense_tf at the winner's lane; tc: the kept lanes' tf bytes) and
//     FLAG_TF_SAT where a kept lane's byte is 255.
//
// Bound: bytes. The least the step must move is the candidate slice (8
// bytes a lane raw, 6 tc), each searched slot's run once, the distinct
// 32-byte sectors of each dense row that the sorted candidate docs touch,
// and the outputs (tools/semidense_bench.semidense_bound_bytes). There are
// no operations to speak of.
//
// Design: this is the bs step's tile path (tile.cuh, compiled here with
// WISER_TILE_SEMI 1), so no (B, L) plane reaches device memory: a worker
// (a warp where L <= 128, else a CTA) takes a query's tiles of candidate
// lanes, streams each searched slot's run through shared memory from a
// per-slot cursor, then gathers each dense slot's row at its live lanes'
// docs, one element a lane (gather_probe measured the element gather the
// fastest of four forms on the card; the candidate docs ascend, so a
// warp's gathers fall in few sectors), and keeps the running top K of
// 64-bit keys in shared memory. Where M + 1 passes the tile path's 1,024
// kept keys (a deep k), the plane path runs: a score plane, then a
// per-query select (tile.cuh's second form). tc scores come from the
// device table of dense.cu's tc_norm_kernel (ops/dense.tc_table, launched
// by the wrapper first), so no lane divides.
//
// Arithmetic: explicit round-to-nearest intrinsics and -fmad=false, so
// the scores equal the plain version's bit for bit.

#define WISER_TILE_NS wiser_semidense
#define WISER_TILE_SEMI 1
#include "tile.cuh"

extern "C" {

// The semidense step on `stream` (tile.cuh launch): no synchronize; the
// first launch error, or cudaErrorInvalidValue for a plan or argument
// set this file's layout refuses.
int wiser_semidense_step(const WiserStepParams* p, void* stream) {
  return wiser_semidense::launch(p, stream);
}

const char* wiser_semidense_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
