"""The dense head-term tier as hand-written CUDA kernels (csrc/dense.cu).

`dense_scan` computes the block-list scan: engine/kernels.dense_scan_body
and dense_scan_body_tc over every 128-doc block of the dense plane, or the
scan half of pruned_scan_body over a (B, C) list of picked blocks, raw or
tc (top_docs, top_score, tfs, flags). `dense_pick` computes
_select_ub_blocks: every block's joint upper bound, plain sum or anchor
form, and the stable top-(C+1) pick (blk (B, C) int64 ascending, next_ub
(B,) f32). `plan` and `pick_plan` say how each runs: a scan CTA takes a
(segment of blocks, query) pair, streams the query's distinct rows
through a ring of shared-memory stages (TMA bulk copies) and keeps its
top K = M + 1 keys in shared memory, so no (B, N_pad) or (B, C * 128)
plane is allocated; tc lanes score from exact tables of the index's
avg32 (`tc_tables` below TC_TFT, `tc_table` past it), with no
division. Each query's blocks are split into as many segments as bring the
grid to whole waves of the card's resident CTAs, and a second launch
merges a split query's lists (counted as dense_scan_merge). The pick is
one CTA a query, or several for a small group (the last to finish
selects), with a radix select whose histograms are counted per warp.

`phrase_select` and `phrase_band` compute the full-scan mega phrase's two
passes (engine/kernels.full_phrase_select and full_phrase_band): the same
scan under the phrase's rule (p = row * weight, or tc the table score
times idf, summed in slot order from 0; matched where every p > 0, so a
weight of 0 matches nothing). The selection keeps K = KV + 1 keys,
threshold first (`select_plan`): a sweep over every block writes each
128-doc block's largest key ("sweep"), then the listed selection finds
the K-th largest block key kappa and streams only the blocks at or above
it, pushing only keys at or above kappa ("select" over K listed blocks);
where the doc space has fewer than K blocks, one pass over every block
("select"). Either keeps its keys in an unsorted buffer cut to its top K
by a radix select, a query's segments (at most MAX_CLUSTER) one cluster
sharing their thresholds and merged in its first CTA, one sort at the
end, and writes them as (score, lane). Then the band pass, whose CTAs
return at once for every query whose (KV+1)-th score is below thr, test
that lane first, and otherwise stream the query's rows until the first
lane of the band: tc after the threshold-first selection only the
blocks whose sweep key scores at least thr (the listed band:
phrase_select's third output, passed to phrase_band as bkeys), else every block (`plan(..., kind=...)`: "sweep", "select" and
"band").

engine/kernels.py calls these for CUDA tensors and runs the plain torch
versions (dense_scan_body_torch, dense_scan_body_tc_torch,
pruned_scan_body_torch, _select_ub_blocks_torch) for CPU tensors, after
`check_inputs` / `check_pick_inputs`. The entries here check the same
conditions with the cheap `args_ok` / `pick_args_ok` before every launch,
so a bad argument raises ValueError the same way on either device.

Where the plain version is exact the kernels equal it bit for bit: the
flags on every row; the kept lanes' docs, f32 scores and tfs, and the
kept set, wherever no boundary tie was cut (FLAG_TRUNC clear); blk and
next_ub always. The kernel's order is (score desc, doc asc), lax.top_k's;
on a flagged row it keeps the lowest docs of the boundary class, which
torch.topk on a card does not promise.

The phrase's selection is the canonical top KV + 1 by (score desc, doc
asc), and so is the plain version's two-level selection (stable sorts):
every block holding a lane above the (KV+1)-th value v is among the KV +
1 blocks it gathers (fewer than KV + 1 lanes lie above v), then the
lowest-id blocks whose maximum is v, and every lane of the class of v
that the canonical set keeps lies in one of them (the blocks below the
first one left out hold at least as many lanes of that class as the set
still needs). So where a tie class straddles the (KV+1)-th place, both
keep its lowest docs: the kernel equals the plain version bit for bit
on every row, ties included (lanes, score bits; -1 and -inf past the
matched lanes). The band pass's word equals the plain version's on the
same selection: its membership test is the key order, the plain
version's a scatter of the selected lanes, which agree on a canonical
selection.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

# kernel launches by wrapper name, counted where a kernel is launched:
# dense_scan the raw scan's, dense_scan_tc the tc scan's, dense_tc_table
# the tc table's launch before each tc scan, tc phrase selection or tc
# semidense step (ops/semidense),
# dense_scan_merge the second launch of a split scan (raw or tc),
# phrase_sweep{,_tc} the selection's block-key sweep, phrase_select{,_tc}
# its selection (listed or one pass) and phrase_band{,_tc} the band pass
launch_counts = {"dense_scan": 0, "dense_scan_tc": 0, "dense_tc_table": 0,
                 "dense_scan_merge": 0, "dense_pick": 0, "phrase_sweep": 0,
                 "phrase_sweep_tc": 0, "phrase_select": 0,
                 "phrase_select_tc": 0, "phrase_band": 0,
                 "phrase_band_tc": 0}
# the running top-K lists in shared memory up to this KP, past it in a
# device scratch (dense.cu kKeySmemCap)
KEY_SMEM_CAP = 4096
THREADS = 256  # a scan or merge CTA
LPT = 4  # lanes a scan thread scores a step
STEP_BLOCKS = 8  # a step's 128-lane blocks at most: THREADS * LPT lanes
MIN_STAGES, MAX_STAGES = 2, 4  # the ring's stages
# the ring's stages together, as far as 2 allow: 16 KB by measurement
# (PERF.md §6; 32 KB no faster, 48-64 KB up to 25% slower; for the
# phrase's sweep and listed selection 16 and 32 KB read the same)
RING_BYTES = 16 * 1024
# tf bytes below this score from the shared norm table (dense.cu kTft),
# the rest from the device table; 16 by measurement among 16, 32 and 64
# (PERF.md §6)
TC_TFT = 16
TC_TABLE_WORDS = 256 * 256  # the device table: every (tf byte, len code)
MERGE_LANES = 1024  # keys a merge step reads
IDS_CAP = 1024  # a block list's ids a segment at most (dense.cu kIdsCap)
FLUSH_BYTES = 1056  # a key flush's shared scratch (dense.cu kFlushBytes)
MAX_SMEM = 232_448  # the shared bytes an H100 block can opt into
# two CTAs an SM: the SM's 233,472 shared bytes less 1 KB a CTA, halved
# (a layout takes a smaller step before it takes more than this)
SMEM_TWO_CTAS = 115_712
# the segments of a query are as many as bring the grid within this
# share of whole waves of the card's resident CTAs (or nearest to it),
# each of at least MIN_SEG_STEPS steps (a shorter one spends more on its
# prologue, its keys and the merge than the last wave's idle share)
WAVE_EFF = 0.9
MIN_SEG_STEPS = 32
UB_SMEM_BYTES = 200 * 1024  # the pick's bounds in shared memory up to this
# a pick group of fewer queries than this splits each query's bounds
# over several CTAs (the H100's SMs), each part of >= PICK_PART blocks
PICK_SPLIT_CTAS = 132
PICK_PART = 1024
MAX_B = 65535  # the scan's and the pick's grid.y
BAND_MAX_T = 128  # the band pass's slots at most (dense.cu kBandMaxT)
# dense.cu kScan, kSelect, kBand, kSweep
KINDS = ("scan", "select", "band", "sweep")
MAX_CLUSTER = 8  # a selection's segments a query: one cluster
# the listed selection's segments a query: as many as bring the group to
# LISTED_CTAS CTAs (at most a cluster's), fewer segments reading each
# more blocks (PERF.md §6)
LISTED_CTAS = 256


class Plan(NamedTuple):
    """How dense_scan runs one (B, T, NB, M, mode) group."""
    NS: int  # ring stages
    step_blocks: int  # 128-lane blocks a step (SB)
    nseg: int  # CTAs a query (> 1: the scan's merge launch runs, the
    # selection's cluster merges)
    bps: int  # blocks a segment
    K: int  # keys kept a query: M + 1
    KP: int  # the power of 2 >= K
    smem: int  # dynamic shared bytes of the scan launch
    merge_smem: int  # of the merge launch (0 without it)
    launches: int  # CUDA launches a call
    part_words: int  # int32 words of the segments' keys
    r_words: int  # int32 words of the running lists' scratch (KP > cap)
    table_words: int  # f32 words of tc's device table
    out_words: int  # int32 words of the outputs
    resident: int  # the card's resident scan CTAs the plan was made for
    wave_eff: float  # CTAs / (whole waves * resident)


class PickPlan(NamedTuple):
    """How dense_pick runs one (B, T, NB, C) group."""
    nsplit: int  # CTAs a query (> 1: bounds in the scratch, the last selects)
    ub_smem: bool  # the NB bounds in shared memory for the select
    smem: int  # dynamic shared bytes
    scratch_words: int  # f32 words of the bounds' scratch
    done_words: int  # the (B,) words the parts count themselves on


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _align16(n: int) -> int:
    return (n + 15) & ~15


def stage_bytes(T: int, mode: str, SB: int = STEP_BLOCKS) -> int:
    """One ring stage: T row segments of SB * 128 lanes (4 B raw, 1 B tc)
    and, tc, the len-code row's segment."""
    tc = mode == "tc"
    SL = SB * 128
    return _align16(T * SL * (1 if tc else 4) + (SL if tc else 0))


def scan_bytes(T: int, KP: int, mode: str, NS: int = MIN_STAGES,
               SB: int = STEP_BLOCKS, listed: bool = False,
               kind: str = "scan") -> int:
    """dense.cu's scan_layout: the stages' mbarriers and the row count
    (48 B) | 3 step counters | a flush's scratch (FLUSH_BYTES) | T row
    offsets, row indices and weights | a block list's segment ids
    (IDS_CAP int64) | tc: the cache and norm tables (256 + 256 * TC_TFT
    f32) | NS stages | R and R2 (KP keys each, up to KEY_SMEM_CAP) and X
    (two steps of keys); the selection: X alone, of KP keys and two
    steps' (select_keys); the band pass and the sweep (KP 0): no keys."""
    tc = mode == "tc"
    if kind == "select":
        keys = 8 * select_keys(KP, SB * 128)
    else:
        keys = ((16 * KP if KP <= KEY_SMEM_CAP else 0) + 16 * SB * 128
                if KP else 0)
    return (48 + 16 + FLUSH_BYTES + _align16(8 * T) + 2 * _align16(4 * T)
            + (8 * IDS_CAP if listed else 0)
            + ((1024 + 4 * 256 * TC_TFT) if tc else 0)
            + NS * stage_bytes(T, mode, SB) + keys)


# the listed selection keeps its query's NB block keys in shared memory
# for its pick (over its ring and key buffer) up to this many bytes
# (dense.cu kPickSmemCap), else reads them from device memory
PICK_SMEM_CAP = 160 * 1024


def pick_smem(NB: int) -> int:
    """dense.cu's pick_smem: the listed pick's block keys in shared
    memory (8 B each), or 0 past PICK_SMEM_CAP."""
    return 8 * NB if 8 * NB <= PICK_SMEM_CAP else 0


def ring_offset(T: int, mode: str, listed: bool = False) -> int:
    """dense.cu's ScanLayout.ring: the bytes ahead of the ring."""
    return (48 + 16 + FLUSH_BYTES + _align16(8 * T) + 2 * _align16(4 * T)
            + (8 * IDS_CAP if listed else 0)
            + ((1024 + 4 * 256 * TC_TFT) if mode == "tc" else 0))


def select_keys(KP: int, lanes: int) -> int:
    """The selection's key buffer (dense.cu xcap): KP keys kept and two
    steps' `lanes` pushed on top."""
    return KP + 2 * lanes


def merge_bytes(KP: int) -> int:
    """dense.cu's merge_bytes: 3 counters | X | a flush's scratch | R and
    R2 (up to KEY_SMEM_CAP)."""
    return (16 + 16 * MERGE_LANES + FLUSH_BYTES
            + (16 * KP if KP <= KEY_SMEM_CAP else 0))


def _fit(T: int, KP: int, mode: str, cap: int, listed: bool, kind: str):
    """(NS, SB, smem) of the largest step, then the most stages (up to
    RING_BYTES together, at least MIN_STAGES), within cap bytes."""
    for SB in (8, 4, 2, 1):
        top = min(MAX_STAGES, max(MIN_STAGES,
                                  RING_BYTES // stage_bytes(T, mode, SB)))
        for NS in range(top, MIN_STAGES - 1, -1):
            smem = scan_bytes(T, KP, mode, NS, SB, listed, kind)
            if smem <= cap:
                return NS, SB, smem
    return None


def scan_layout(T: int, KP: int, mode: str, listed: bool = False,
                kind: str = "scan"):
    """(NS, SB, smem) of a scan (listed: over a block list) of that kind:
    the largest step whose layout leaves room for two CTAs an SM, else
    the largest within the block's limit. Raises ValueError where none
    fits (T in the hundreds)."""
    fit = (_fit(T, KP, mode, SMEM_TWO_CTAS, listed, kind)
           or _fit(T, KP, mode, MAX_SMEM, listed, kind))
    if fit is None:
        raise ValueError(f"no scan layout fits {MAX_SMEM} shared bytes at "
                         f"T={T}, KP={KP}")
    return fit


def _segments(B: int, steps: int, SB: int, resident: int, max_bps: int):
    """(nseg, bps, eff): the fewest segments of whole steps (of at most
    max_bps blocks, at least MIN_SEG_STEPS steps where there are that
    many) whose grid (B * nseg CTAs) comes within WAVE_EFF of whole waves
    of `resident` CTAs, else the count nearest to them; the fewest
    segments where the queries alone fill two waves (the last wave's
    idle share is then under a third, and a split would add the merge
    launch)."""
    least = -(-steps // (max_bps // SB))
    most = max(least, steps // MIN_SEG_STEPS)
    if B >= 2 * resident:
        sps = -(-steps // least)
        nseg = -(-steps // sps)
        items = B * nseg
        return nseg, sps * SB, items / (-(-items // resident) * resident)
    best = None
    prev = 0
    for n in range(least, most + 1):
        sps = -(-steps // n)  # steps a segment
        nseg = -(-steps // sps)
        if nseg == prev:
            continue
        prev = nseg
        items = B * nseg
        eff = items / (-(-items // resident) * resident)
        if eff >= WAVE_EFF:
            return nseg, sps * SB, eff
        if best is None or eff > best[2]:
            best = (nseg, sps * SB, eff)
    return best


def _layout_kp(M: int, kind: str) -> int:
    """The KP of a kind's layout: the power of 2 >= M + 1 keys, 0 for the
    band pass and the sweep (they keep none)."""
    return 0 if kind in ("band", "sweep") else _pow2(M + 1)


@functools.lru_cache(maxsize=4096)
def plan(B: int, T: int, NB: int, M: int, mode: str, resident: int,
         listed: bool = False, kind: str = "scan", pick_nb: int = 0) -> Plan:
    """The launch plan of a scan group (arguments already checked): NB is
    the lane set's blocks (N_pad / 128 for the full scan, C for a block
    list: listed; the listed selection's K ranks); `resident` the card's
    resident CTAs at the layout's shared bytes (resident_for on a card).
    A ring of stages, and each query's blocks in segments of whole steps,
    as many as bring the grid to whole waves (a block list's segments of
    at most IDS_CAP blocks). kind "select" (the phrase's selection, M =
    KV: K = KV + 1 keys written as (lane, score); at most MAX_CLUSTER
    segments a query, one cluster, no merge launch; its tc table launched
    by the one pass, the listed selection reading its sweep's), "sweep"
    (the selection's block keys: no keys kept, no merge; (B, NB) 64-bit
    keys out) or "band" (its band pass: no keys, no merge, no tc table;
    one word a query; listed, its segments' blocks at most IDS_CAP, over
    the blocks its sweep's keys list). pick_nb: the listed selection's
    doc space in blocks, whose keys its pick holds in shared memory
    (pick_smem) over its ring and key buffer."""
    K = M + 1
    KP = _layout_kp(M, kind)
    NS, SB, smem = scan_layout(T, KP, mode, listed, kind)
    if pick_nb:
        smem = max(smem, ring_offset(T, mode, listed) + pick_smem(pick_nb))
    steps = -(-NB // SB)
    nseg, bps, eff = _segments(B, steps, SB, resident,
                               IDS_CAP if listed else steps * SB)
    if kind == "select":
        # at most a cluster; the listed selection's to LISTED_CTAS CTAs
        want = (max(-(-steps // (IDS_CAP // SB)),
                    min(MAX_CLUSTER, -(-LISTED_CTAS // max(B, 1))))
                if listed else min(nseg, MAX_CLUSTER))
        sps = -(-steps // want)
        nseg = -(-steps // sps)
        bps = sps * SB
        items = B * nseg
        eff = items / (-(-items // resident) * resident)
    split = nseg > 1 and kind == "scan"
    merge_smem = merge_bytes(KP) if split else 0
    part_words = 2 * B * nseg * K if split else 0
    r_words = (0 if KP <= KEY_SMEM_CAP or kind != "scan"
               else 4 * B * nseg * KP)
    table = mode == "tc" and (kind in ("scan", "sweep")
                              or (kind == "select" and not listed))
    out_words = {"scan": B * (2 * M + T * M + 1), "select": 2 * B * K,
                 "band": B, "sweep": 2 * B * NB}[kind]
    return Plan(NS, SB, nseg, bps, K, KP, smem, merge_smem,
                1 + split + table, part_words, r_words,
                TC_TABLE_WORDS if table else 0, out_words, resident, eff)


class SelectPlan(NamedTuple):
    """How phrase_select runs one (B, T, NB, KV, mode) group."""
    path: str  # "two": the sweep, then the listed selection; "one"
    sweep: Optional[Plan]  # the sweep's plan ("two")
    select: Plan  # the selection's: over K listed blocks, or every block
    launches: int  # CUDA launches a call, tc's table included


def select_path(B: int, NB: int, KV: int) -> str:
    """The selection's path: "two" (threshold first) where the doc space
    has at least K = KV + 1 blocks and a cluster's listed segments hold K
    (K <= MAX_CLUSTER * IDS_CAP), else "one". On the 1M index's planes
    threshold first was the faster at every group and KV the engine runs,
    the rescue's K = 4,097 of 7,816 blocks included (PERF.md §6)."""
    K = KV + 1
    return "one" if NB < K or K > MAX_CLUSTER * IDS_CAP else "two"


def select_plan(B: int, T: int, NB: int, KV: int, mode: str,
                resident) -> SelectPlan:
    """The selection's launch plans (arguments already checked) on NB
    blocks, by select_path: "two", the sweep over every block then the
    selection over K = KV + 1 listed ranks, or "one", the selection over
    every block. resident(kind, listed) -> the card's resident CTAs of
    that layout (resident_for on a card; the listed selection's with its
    pick's keys, pick_nb = NB)."""
    path = select_path(B, NB, KV)
    if path not in ("one", "two") or (path == "two" and NB < KV + 1):
        raise ValueError(f"no selection path {path!r} at NB={NB}, KV={KV}")
    if path == "one":
        sel = plan(B, T, NB, KV, mode, resident("select", False),
                   kind="select")
        return SelectPlan("one", None, sel, sel.launches)
    sweep = plan(B, T, NB, KV, mode, resident("sweep", False), kind="sweep")
    sel = plan(B, T, KV + 1, KV, mode, resident("select", True),
               listed=True, kind="select", pick_nb=NB)
    return SelectPlan("two", sweep, sel, sweep.launches + sel.launches)


@functools.lru_cache(maxsize=4096)
def pick_plan(B: int, T: int, NB: int, C: int) -> PickPlan:
    """The pick's plan: a group of fewer than PICK_SPLIT_CTAS queries
    splits each query's bounds over up to that many CTAs together (parts
    of at least PICK_PART blocks), into a (B, NB) f32 scratch; the select
    reads the bounds from shared memory up to UB_SMEM_BYTES, else from
    that scratch."""
    nsplit = max(1, min(-(-PICK_SPLIT_CTAS // max(B, 1)), NB // PICK_PART))
    ub_smem = 4 * NB <= UB_SMEM_BYTES
    smem = _align16(8 * T) + _align16(4 * T) + (4 * NB if ub_smem else 0)
    scratch = B * NB if (nsplit > 1 or not ub_smem) else 0
    return PickPlan(nsplit, ub_smem, smem, scratch,
                    B if nsplit > 1 else 0)


def tc_tables(avg32):
    """The tc scan's exact tables as dense.cu fills them (keys.cuh
    tc_fill_tables), in f32 on avg32's device: cache (256,) the length
    term of each len code, norm (256, TC_TFT) the tf part of the score of
    each (code, tf < TC_TFT), before the multiply by idf; each entry one
    round-to-nearest f32 operation at a time, in tc_score's order."""
    avg = avg32.reshape(()).to(torch.float32)
    dev = avg.device
    code = torch.arange(256, dtype=torch.int32, device=dev)
    bits = code & 7
    shift = ((code >> 3) - 1).clamp(max=27)
    length = torch.where(shift < 0, bits, (bits | 8) << shift.clamp(min=0))
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    cache = f32(1.2) * (f32(0.25) + f32(0.75) * length.to(torch.float32)
                        / avg)
    tf = torch.arange(TC_TFT, dtype=torch.float32, device=dev)
    norm = (tf[None, :] * f32(2.2)) / (tf[None, :] + cache[:, None])
    return cache, norm


def tc_table_torch(avg32):
    """The tc scan's device table's plain version: (256, 256) f32,
    [tf, code] = the tf part of the score of that lane (255: 2.2)."""
    return tc_lane_scores(avg32, 1.0).T.contiguous()


def tc_table(avg32):
    """The tc scan's device table (dense.cu tc_norm_kernel, which
    dense_scan launches before every tc scan) for a one-element f32
    avg32: on a CUDA tensor the kernel alone (counted as
    dense_tc_table), on the CPU tc_table_torch."""
    _need(isinstance(avg32, _T) and avg32.dtype is torch.float32
          and avg32.numel() == 1 and avg32.is_contiguous(),
          "avg32 must be a contiguous one-element float32 tensor")
    if avg32.device.type != "cuda":
        return tc_table_torch(avg32)
    out = torch.empty((256, 256), dtype=torch.float32, device=avg32.device)
    fns = _kernel_fns()
    idx = (avg32.device.index if avg32.device.index is not None
           else torch.cuda.current_device())
    with torch.cuda.device(idx):
        rc = fns.tc_table(avg32.data_ptr(), out.data_ptr(),
                          torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError("dense_tc_table launch failed: "
                           + fns.error(rc).decode())
    launch_counts["dense_tc_table"] += 1
    return out


def tc_lane_scores(avg32, idf: float):
    """(256, 256) f32: the score the tc scan gives a lane of len code c
    and tf byte f in a slot of this idf: idf * norm[c, f] below TC_TFT
    (the shared table), the division of tc_score_cached at and above it
    (the device table; 255: idf * 2.2)."""
    cache, norm = tc_tables(avg32)
    dev = cache.device
    w = torch.tensor(idf, dtype=torch.float32, device=dev)
    tf = torch.arange(256, dtype=torch.float32, device=dev)
    k1p1 = torch.tensor(2.2, dtype=torch.float32, device=dev)
    div = (tf[None, :] * k1p1) / (tf[None, :] + cache[:, None])
    div[:, 255] = k1p1
    full = torch.cat([norm, div[:, TC_TFT:]], dim=1)
    return w * full


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


_T = torch.Tensor


def _ok(t, dtype, shape, dev, aligned: bool = False) -> bool:
    """A contiguous tensor of dtype and shape on dev (and 16-byte aligned,
    for the rows the scan reads 16 bytes at a time)."""
    return (isinstance(t, _T) and t.dtype is dtype
            and tuple(t.shape) == shape and t.is_contiguous()
            and t.device == dev and (not aligned or t.data_ptr() % 16 == 0))


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _tensor(name, t, dtype, shape, dev, aligned: bool = False) -> None:
    what = "contiguous, 16-byte aligned" if aligned else "contiguous"
    _need(_ok(t, dtype, shape, dev, aligned),
          f"{name} must be a {what} {dtype} tensor of shape {shape} on {dev}")


def _scan_shapes(plane, slots, blocks, T: int, N_pad: int, M: int):
    """(dev, H, B, lanes) of a scan call, or None where the leading
    arguments cannot say."""
    if (not isinstance(plane, _T) or plane.dim() != 2
            or not isinstance(slots, _T) or slots.dim() != 2):
        return None
    lanes = N_pad if blocks is None else (
        blocks.shape[1] * 128 if isinstance(blocks, _T)
        and blocks.dim() == 2 else -1)
    return plane.device, plane.shape[0], slots.shape[0], lanes


def check_inputs(plane, tf_plane, slots, weights, *, T: int, N_pad: int,
                 M: int, blocks=None, len_code=None, avg32=None) -> None:
    """Raise ValueError unless the arguments are what the scan takes: the
    (H, N_pad) plane (raw f32 scores with the int32 tf plane, or tc uint8
    tfs with the (N_pad,) uint8 len-code row and a one-element f32 avg32),
    N_pad a positive multiple of 128; (B, T) int32 slots and f32 weights;
    blocks None (every block) or (B, C) int64 with 1 <= C <= N_pad / 128;
    1 <= M <= the lane set (N_pad or C * 128); every
    tensor contiguous and on the plane's device (cpu or cuda), the plane
    and len_code 16-byte aligned."""
    sh = _scan_shapes(plane, slots, blocks, T, N_pad, M)
    _need(sh is not None, "plane and slots must be 2-D tensors")
    dev, H, B, lanes = sh
    _need(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _need(T >= 1 and H >= 1 and N_pad >= 128 and N_pad % 128 == 0,
          f"need T >= 1, H >= 1 and N_pad a positive multiple of 128, got "
          f"T={T} H={H} N_pad={N_pad}")
    tc = len_code is not None
    _tensor("plane", plane, torch.uint8 if tc else torch.float32,
            (H, N_pad), dev, True)
    if tc:
        _tensor("len_code", len_code, torch.uint8, (N_pad,), dev, True)
        _need(isinstance(avg32, _T) and avg32.dtype is torch.float32
              and avg32.numel() == 1 and avg32.device == dev,
              f"avg32 must be a one-element float32 tensor on {dev}")
    else:
        _tensor("tf_plane", tf_plane, torch.int32, (H, N_pad), dev)
    _tensor("slots", slots, torch.int32, (B, T), dev)
    _tensor("weights", weights, torch.float32, (B, T), dev)
    if blocks is not None:
        _need(isinstance(blocks, _T) and blocks.dim() == 2,
              "blocks must be a (B, C) tensor")
        C = blocks.shape[1]
        _tensor("blocks", blocks, torch.int64, (B, C), dev)
        _need(1 <= C <= N_pad // 128,
              f"need 1 <= C <= N_pad / 128, got C={C}")
    _need(1 <= M <= lanes, f"need 1 <= M <= {lanes} lanes, got M={M}")


def args_ok(plane, tf_plane, slots, weights, *, T: int, N_pad: int, M: int,
            blocks=None, len_code=None, avg32=None) -> bool:
    """check_inputs's conditions as one cheap test: True exactly where
    check_inputs raises nothing."""
    sh = _scan_shapes(plane, slots, blocks, T, N_pad, M)
    if sh is None:
        return False
    dev, H, B, lanes = sh
    if not (dev.type in ("cpu", "cuda") and T >= 1 and H >= 1
            and N_pad >= 128 and N_pad % 128 == 0 and 1 <= M <= lanes
            and _ok(slots, torch.int32, (B, T), dev)
            and _ok(weights, torch.float32, (B, T), dev)):
        return False
    if blocks is not None and not (
            _ok(blocks, torch.int64, (B, blocks.shape[1]), dev)
            and blocks.shape[1] <= N_pad // 128):
        return False
    if len_code is not None:
        return (_ok(plane, torch.uint8, (H, N_pad), dev, True)
                and _ok(len_code, torch.uint8, (N_pad,), dev, True)
                and isinstance(avg32, _T) and avg32.dtype is torch.float32
                and avg32.numel() == 1 and avg32.device == dev)
    return (_ok(plane, torch.float32, (H, N_pad), dev, True)
            and _ok(tf_plane, torch.int32, (H, N_pad), dev))


def check_pick_inputs(blockmax, slots, weights, *, T: int, NB: int, C: int,
                      blockmax2=None, argpos=None) -> None:
    """Raise ValueError unless the arguments are what the pick takes: the
    (H, NB) f32 blockmax (with blockmax2 f32 and argpos uint8 of the same
    shape, both or neither), (B, T) int32 slots and f32 weights, T >= 1
    and 1 <= C < NB; every tensor contiguous and on blockmax's device (cpu
    or cuda)."""
    _need(isinstance(blockmax, _T) and blockmax.dim() == 2
          and isinstance(slots, _T) and slots.dim() == 2,
          "blockmax and slots must be 2-D tensors")
    dev, H, B = blockmax.device, blockmax.shape[0], slots.shape[0]
    _need(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _need(T >= 1 and H >= 1 and 1 <= C < NB,
          f"need T >= 1, H >= 1 and 1 <= C < NB, got T={T} H={H} C={C} "
          f"NB={NB}")
    _tensor("blockmax", blockmax, torch.float32, (H, NB), dev)
    _need((blockmax2 is None) == (argpos is None),
          "blockmax2 and argpos go together")
    if blockmax2 is not None:
        _tensor("blockmax2", blockmax2, torch.float32, (H, NB), dev)
        _tensor("argpos", argpos, torch.uint8, (H, NB), dev)
    _tensor("slots", slots, torch.int32, (B, T), dev)
    _tensor("weights", weights, torch.float32, (B, T), dev)


def pick_args_ok(blockmax, slots, weights, *, T: int, NB: int, C: int,
                 blockmax2=None, argpos=None) -> bool:
    """check_pick_inputs's conditions as one cheap test."""
    if not (isinstance(blockmax, _T) and blockmax.dim() == 2
            and isinstance(slots, _T) and slots.dim() == 2):
        return False
    dev, H, B = blockmax.device, blockmax.shape[0], slots.shape[0]
    if not (dev.type in ("cpu", "cuda") and T >= 1 and H >= 1
            and 1 <= C < NB and (blockmax2 is None) == (argpos is None)
            and _ok(blockmax, torch.float32, (H, NB), dev)
            and _ok(slots, torch.int32, (B, T), dev)
            and _ok(weights, torch.float32, (B, T), dev)):
        return False
    return blockmax2 is None or (
        _ok(blockmax2, torch.float32, (H, NB), dev)
        and _ok(argpos, torch.uint8, (H, NB), dev))


def check_pruned_inputs(dense, dense_tf, len_code, avg32, blockmax,
                        blockmax2, argpos, slots, weights, *, T: int,
                        NB: int, C: int, M: int) -> None:
    """pruned_scan_body's conditions: the pick's (check_pick_inputs, with
    the bound's weights) and the scan's over C picked blocks
    (check_inputs, M <= C * 128)."""
    check_pick_inputs(blockmax, slots, weights, T=T, NB=NB, C=C,
                      blockmax2=blockmax2, argpos=argpos)
    check_inputs(dense, dense_tf, slots, weights, T=T, N_pad=NB * 128, M=M,
                 len_code=len_code, avg32=avg32)
    _need(M <= C * 128, f"need M <= C * 128 lanes, got M={M} C={C}")


def pruned_args_ok(dense, dense_tf, len_code, avg32, blockmax, blockmax2,
                   argpos, slots, weights, *, T: int, NB: int, C: int,
                   M: int) -> bool:
    """check_pruned_inputs's conditions as one cheap test."""
    return (M <= C * 128
            and pick_args_ok(blockmax, slots, weights, T=T, NB=NB, C=C,
                             blockmax2=blockmax2, argpos=argpos)
            and args_ok(dense, dense_tf, slots, weights, T=T, N_pad=NB * 128,
                        M=M, len_code=len_code, avg32=avg32))


class _ScanParams(ctypes.Structure):
    """dense.cu's WiserDenseScanParams: every field 8 bytes, in order."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "sc tf tf8 code avg32 norm_g slots weights blocks H N_pad B T M nblk "
        "K KP nseg bps NS SB smem merge_smem part_keys rscratch "
        "top_docs top_score top_tfs flags kind sel_lanes sel_score thr "
        "kth_doc hit bkeys").split()]


class _PickParams(ctypes.Structure):
    """dense.cu's WiserDensePickParams."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "bm bm2 ap slots weights H NB B T C nsplit ub_smem smem ub_scratch "
        "done blk next_ub").split()]


class _Fns:
    """The kernel library's C functions, bound once."""

    def __init__(self, lib: ctypes.CDLL):
        self.scan = lib.wiser_dense_scan
        self.scan.argtypes = [ctypes.POINTER(_ScanParams), ctypes.c_void_p]
        self.scan.restype = ctypes.c_int
        self.pick = lib.wiser_dense_pick
        self.pick.argtypes = [ctypes.POINTER(_PickParams), ctypes.c_void_p]
        self.pick.restype = ctypes.c_int
        self.tc_table = lib.wiser_dense_tc_table
        self.tc_table.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
        self.tc_table.restype = ctypes.c_int
        self.resident = lib.wiser_dense_resident
        self.resident.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_longlong]
        self.resident.restype = ctypes.c_int
        self.error = lib.wiser_dense_error_string
        self.error.argtypes = [ctypes.c_int]
        self.error.restype = ctypes.c_char_p


_fns: Optional[_Fns] = None


def _kernel_fns() -> _Fns:
    """Build and bind the kernel library at first use."""
    global _fns
    if _fns is None:
        from wiser_tpu_torch.build import load_library

        _fns = _Fns(load_library("dense"))
    return _fns


@functools.lru_cache(maxsize=256)
def _resident(mode: str, smem: int, idx: int, kind: str = "scan") -> int:
    fns = _kernel_fns()
    with torch.cuda.device(idx):
        n = fns.resident(int(mode == "tc"), KINDS.index(kind), smem)
    if n <= 0:
        raise RuntimeError("dense_scan occupancy query failed: "
                           + fns.error(-n).decode())
    return n


def resident_for(mode: str, T: int, M: int, dev: torch.device,
                 listed: bool = False, kind: str = "scan",
                 pick_nb: int = 0) -> int:
    """The card's resident scan CTAs (SMs times CTAs an SM, from the CUDA
    runtime's occupancy) of that kind's kernel at the layout plan() picks
    for these arguments."""
    _, _, smem = scan_layout(T, _layout_kp(M, kind), mode, listed, kind)
    if pick_nb:
        smem = max(smem, ring_offset(T, mode, listed) + pick_smem(pick_nb))
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    return _resident(mode, smem, idx, kind)


def _launch(fn, params, dev: torch.device, what: str) -> None:
    fns = _kernel_fns()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx == torch.cuda.current_device():
        rc = fn(fns)(ctypes.byref(params),
                     torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            rc = fn(fns)(ctypes.byref(params),
                         torch._C._cuda_getCurrentRawStream(idx))
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: " + fns.error(rc).decode())


def dense_scan(plane, tf_plane, slots, weights, *, T: int, N_pad: int,
               M: int, blocks=None, len_code=None, avg32=None):
    """The block-list scan's outputs from the kernel, on CUDA tensors:
    (top_docs (B, M) int32 lanes of the plane or -1, top_score (B, M) f32,
    tfs (B, T, M) int32, flags (B,) int32). raw: plane is the f32 score
    plane, tf_plane the int32 tfs, weights use_score; tc (len_code
    given): plane is the uint8 tf plane, tf_plane unused, weights idf32.
    blocks: None (every block) or (B, C) int64 ascending block ids. Checks
    the arguments as check_inputs does (ValueError before any launch),
    allocates the outputs (and the segments' keys and, past KEY_SMEM_CAP,
    the running lists' scratch) as views of one buffer, launches on the
    current stream and does not synchronize."""
    kw = dict(T=T, N_pad=N_pad, M=M, blocks=blocks, len_code=len_code,
              avg32=avg32)
    if not (args_ok(plane, tf_plane, slots, weights, **kw)
            and plane.device.type == "cuda"):
        check_inputs(plane, tf_plane, slots, weights, **kw)
        raise ValueError(f"dense_scan runs on CUDA tensors, got "
                         f"{plane.device}")
    dev = plane.device
    B = slots.shape[0]
    if B > MAX_B:
        raise ValueError(f"B = {B} queries exceed the grid's {MAX_B}")
    tc = len_code is not None
    mode = "tc" if tc else "raw"
    nblk = N_pad // 128 if blocks is None else blocks.shape[1]
    listed = blocks is not None
    p = plan(B, T, nblk, M, mode,
             resident_for(mode, T, M, dev, listed) if B else 1, listed)
    buf = torch.empty(p.part_words + p.r_words + p.table_words
                      + p.out_words, dtype=torch.int32, device=dev)
    BM, BTM = B * M, B * T * M
    _, _, _, docs, score, tfs, flags = buf.split(
        (p.part_words, p.r_words, p.table_words, BM, BM, BTM, B))
    res = (docs.view(B, M), score.view(torch.float32).view(B, M),
           tfs.view(B, T, M), flags)
    if B == 0:
        return res
    # the segments' keys, then the running lists' scratch (both 8-byte
    # aligned), tc's table, then the outputs
    base = buf.data_ptr()
    table = base + 4 * (p.part_words + p.r_words)
    o = table + 4 * p.table_words
    params = _ScanParams(
        0 if tc else plane.data_ptr(), 0 if tc else tf_plane.data_ptr(),
        plane.data_ptr() if tc else 0, len_code.data_ptr() if tc else 0,
        avg32.data_ptr() if tc else 0, table if tc else 0,
        slots.data_ptr(), weights.data_ptr(),
        0 if blocks is None else blocks.data_ptr(), plane.shape[0], N_pad, B,
        T, M, nblk, p.K, p.KP, p.nseg, p.bps, p.NS, p.step_blocks, p.smem,
        p.merge_smem,
        base if p.part_words else 0,
        base + 4 * p.part_words if p.r_words else 0, o, o + 4 * BM,
        o + 8 * BM, o + 4 * (2 * BM + BTM), 0, 0, 0, 0, 0, 0, 0)
    _launch(lambda f: f.scan, params, dev, "dense_scan")
    if tc:
        launch_counts["dense_scan_tc"] += 1
        launch_counts["dense_tc_table"] += 1
    else:
        launch_counts["dense_scan"] += 1
    if p.nseg > 1:
        launch_counts["dense_scan_merge"] += 1
    return res


def check_phrase_inputs(plane, slots, weights, *, T: int, N_pad: int,
                        KV: int, len_code=None, avg32=None,
                        band=None, bkeys=None) -> None:
    """Raise ValueError unless the arguments are what the phrase's passes
    take: the (H, N_pad) plane (raw f32 scores, or tc uint8 tfs with the
    (N_pad,) uint8 len-code row and a one-element f32 avg32; the plane and
    len_code 16-byte aligned), N_pad a positive multiple of 128, (B, T)
    int32 slots and f32 weights (query-term order), 1 <= KV < N_pad; for
    the band pass, band = (top_cs (B, KV + 1) f32, top_cl (B, KV + 1)
    int32, thr (B,) f32, kth_doc (B,) int32 in tc, else None) and T <=
    BAND_MAX_T, with the selection's (B, N_pad / 128) int64 block keys
    bkeys or None; every tensor contiguous and on the plane's device (cpu
    or cuda)."""
    _need(isinstance(plane, _T) and plane.dim() == 2
          and isinstance(slots, _T) and slots.dim() == 2,
          "plane and slots must be 2-D tensors")
    dev, H, B = plane.device, plane.shape[0], slots.shape[0]
    _need(dev.type in ("cpu", "cuda"), f"unsupported device {dev}")
    _need(T >= 1 and H >= 1 and N_pad >= 128 and N_pad % 128 == 0,
          f"need T >= 1, H >= 1 and N_pad a positive multiple of 128, got "
          f"T={T} H={H} N_pad={N_pad}")
    _need(1 <= KV < N_pad, f"need 1 <= KV < N_pad, got KV={KV} "
                           f"N_pad={N_pad}")
    tc = len_code is not None
    _tensor("plane", plane, torch.uint8 if tc else torch.float32,
            (H, N_pad), dev, True)
    if tc:
        _tensor("len_code", len_code, torch.uint8, (N_pad,), dev, True)
        _need(isinstance(avg32, _T) and avg32.dtype is torch.float32
              and avg32.numel() == 1 and avg32.device == dev,
              f"avg32 must be a one-element float32 tensor on {dev}")
    _tensor("slots", slots, torch.int32, (B, T), dev)
    _tensor("weights", weights, torch.float32, (B, T), dev)
    if band is not None:
        top_cs, top_cl, thr, kth_doc = band
        _need(T <= BAND_MAX_T, f"the band pass takes T <= {BAND_MAX_T}, "
                               f"got T={T}")
        _tensor("top_cs", top_cs, torch.float32, (B, KV + 1), dev)
        _tensor("top_cl", top_cl, torch.int32, (B, KV + 1), dev)
        _tensor("thr", thr, torch.float32, (B,), dev)
        _need((kth_doc is not None) == tc,
              "kth_doc goes with tc columns, and only with them")
        if tc:
            _tensor("kth_doc", kth_doc, torch.int32, (B,), dev)
        if bkeys is not None:
            _tensor("bkeys", bkeys, torch.int64, (B, N_pad // 128), dev)


def phrase_args_ok(plane, slots, weights, *, T: int, N_pad: int, KV: int,
                   len_code=None, avg32=None, band=None,
                   bkeys=None) -> bool:
    """check_phrase_inputs's conditions as one cheap test."""
    if not (isinstance(plane, _T) and plane.dim() == 2
            and isinstance(slots, _T) and slots.dim() == 2):
        return False
    dev, H, B = plane.device, plane.shape[0], slots.shape[0]
    tc = len_code is not None
    if not (dev.type in ("cpu", "cuda") and T >= 1 and H >= 1
            and N_pad >= 128 and N_pad % 128 == 0 and 1 <= KV < N_pad
            and _ok(plane, torch.uint8 if tc else torch.float32, (H, N_pad),
                    dev, True)
            and _ok(slots, torch.int32, (B, T), dev)
            and _ok(weights, torch.float32, (B, T), dev)):
        return False
    if tc and not (_ok(len_code, torch.uint8, (N_pad,), dev, True)
                   and isinstance(avg32, _T) and avg32.dtype is torch.float32
                   and avg32.numel() == 1 and avg32.device == dev):
        return False
    if band is None:
        return True
    top_cs, top_cl, thr, kth_doc = band
    return (T <= BAND_MAX_T and _ok(top_cs, torch.float32, (B, KV + 1), dev)
            and _ok(top_cl, torch.int32, (B, KV + 1), dev)
            and _ok(thr, torch.float32, (B,), dev)
            and (kth_doc is not None) == tc
            and (not tc or _ok(kth_doc, torch.int32, (B,), dev))
            and (bkeys is None
                 or _ok(bkeys, torch.int64, (B, N_pad // 128), dev)))


def _phrase_checked(what: str, plane, slots, weights, *, T: int,
                    N_pad: int, KV: int, len_code, avg32, band, bkeys=None):
    """Check one of the phrase's passes' arguments (ValueError before any
    launch); returns (device, B, mode)."""
    kw = dict(T=T, N_pad=N_pad, KV=KV, len_code=len_code, avg32=avg32,
              band=band, bkeys=bkeys)
    if not (phrase_args_ok(plane, slots, weights, **kw)
            and plane.device.type == "cuda"):
        check_phrase_inputs(plane, slots, weights, **kw)
        raise ValueError(f"{what} runs on CUDA tensors, got {plane.device}")
    B = slots.shape[0]
    if B > MAX_B:
        raise ValueError(f"B = {B} queries exceed the grid's {MAX_B}")
    return plane.device, B, "tc" if len_code is not None else "raw"


def _phrase_params(kind: str, p: Plan, plane, slots, weights, *, T: int,
                   N_pad: int, KV: int, nblk: int, len_code, avg32,
                   table: int = 0, bkeys: int = 0, outs=(0, 0),
                   band=None, hit: int = 0) -> _ScanParams:
    """One phrase pass's _ScanParams: the plane and the query's rows, the
    plan, tc's table, the block keys, the selection's (lanes, scores)
    outputs or the band's selection, thresholds and words."""
    tc = len_code is not None
    top_cs, top_cl, thr, kth_doc = band if band is not None else (None,) * 4
    return _ScanParams(
        0 if tc else plane.data_ptr(), 0, plane.data_ptr() if tc else 0,
        len_code.data_ptr() if tc else 0, avg32.data_ptr() if tc else 0,
        table, slots.data_ptr(), weights.data_ptr(), 0, plane.shape[0],
        N_pad, slots.shape[0], T, KV, nblk, p.K, p.KP, p.nseg, p.bps, p.NS,
        p.step_blocks, p.smem, 0, 0, 0, outs[0], outs[1], 0, 0,
        KINDS.index(kind), 0 if band is None else top_cl.data_ptr(),
        0 if band is None else top_cs.data_ptr(),
        0 if band is None else thr.data_ptr(),
        kth_doc.data_ptr() if kth_doc is not None else 0, hit, bkeys)


def phrase_select(plane, slots, weights, *, T: int, N_pad: int, KV: int,
                  len_code=None, avg32=None):
    """The full-scan phrase's selection from the kernels, on CUDA tensors:
    each query's top K = KV + 1 lanes of the plane under the phrase's
    rule, in (score desc, doc asc) order, as (top_cs (B, K) f32, top_cl
    (B, K) int32; -inf and -1 past the matched lanes, bkeys). raw: plane is the
    f32 score plane, weights use_score; tc (len_code given): plane is the
    uint8 tf plane, weights idf32. `select_plan` picks the path: "two",
    the sweep (its block keys in the call's buffer) then the listed
    selection; "one", the selection over every block. Checks the
    arguments as check_phrase_inputs does (ValueError before any launch),
    allocates the block keys, tc's table and the outputs as views of one
    buffer, launches on the current stream and does not synchronize.
    bkeys is the sweep's (B, NB) int64 block keys (a view of the same
    buffer, which the listed band pass reads: phrase_band's bkeys), or
    None where the path took one pass."""
    dev, B, mode = _phrase_checked("phrase_select", plane, slots, weights,
                                   T=T, N_pad=N_pad, KV=KV,
                                   len_code=len_code, avg32=avg32,
                                   band=None)
    NB, K = N_pad // 128, KV + 1
    tc = mode == "tc"
    if B == 0:
        empty = (torch.empty((0, K), dtype=torch.float32, device=dev),
                 torch.empty((0, K), dtype=torch.int32, device=dev))
        return empty + (None,)
    sp = select_plan(B, T, NB, KV, mode,
                     lambda kind, listed: resident_for(
                         mode, T, KV, dev, listed, kind,
                         NB if listed else 0))
    key_words = sp.sweep.out_words if sp.sweep else 0
    table_words = TC_TABLE_WORDS if tc else 0
    buf = torch.empty(key_words + table_words + 2 * B * K,
                      dtype=torch.int32, device=dev)
    # the block keys first (8-byte aligned), tc's table, the outputs
    base = buf.data_ptr()
    bkeys = base if sp.sweep else 0
    table = base + 4 * key_words if tc else 0
    o = base + 4 * (key_words + table_words)
    kw = dict(T=T, N_pad=N_pad, KV=KV, len_code=len_code, avg32=avg32,
              table=table, bkeys=bkeys)
    sfx = "_tc" if tc else ""
    if sp.sweep:
        _launch(lambda f: f.scan,
                _phrase_params("sweep", sp.sweep, plane, slots, weights,
                               nblk=NB, **kw), dev, "phrase_sweep")
        launch_counts["phrase_sweep" + sfx] += 1
    _launch(lambda f: f.scan,
            _phrase_params("select", sp.select, plane, slots, weights,
                           nblk=K if sp.sweep else NB,
                           outs=(o, o + 4 * B * K), **kw),
            dev, "phrase_select")
    launch_counts["phrase_select" + sfx] += 1
    if tc:
        launch_counts["dense_tc_table"] += 1
    out = buf[key_words + table_words:]
    return (out[B * K:].view(torch.float32).view(B, K),
            out[: B * K].view(B, K),
            buf[:key_words].view(torch.int64).view(B, NB)
            if sp.sweep else None)


def phrase_band(plane, slots, weights, top_cs, top_cl, thr, *, T: int,
                N_pad: int, KV: int, kth_doc=None, len_code=None,
                avg32=None, bkeys=None):
    """The full-scan phrase's band pass from the kernel, on CUDA tensors:
    (B,) int32, 1 where some lane outside the selection (top_cs, top_cl
    from phrase_select) matches, scores at least thr and ranks after the
    KV-th selected lane (tc: and its payload differs from kth_doc's on
    some term or its doc is below kth_doc), else 0. tc with bkeys (the
    selection's (B, NB) int64 block keys, phrase_select's third output)
    a query that needs the band streams only the blocks whose key scores
    at least thr (the listed band, segments of at most IDS_CAP blocks),
    else every block; raw takes no keys (a raw row that needs the band
    always flags at its (KV+1)-th lane, before any block). Checks the
    arguments as check_phrase_inputs does, launches on the current stream
    (the words zeroed first) and does not synchronize."""
    band = (top_cs, top_cl, thr, kth_doc)
    dev, B, mode = _phrase_checked("phrase_band", plane, slots, weights,
                                   T=T, N_pad=N_pad, KV=KV,
                                   len_code=len_code, avg32=avg32,
                                   band=band, bkeys=bkeys)
    hit = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return hit
    NB = N_pad // 128
    listed = bkeys is not None and mode == "tc"
    p = plan(B, T, NB, KV, mode,
             resident_for(mode, T, KV, dev, listed, kind="band"),
             listed=listed, kind="band")
    _launch(lambda f: f.scan,
            _phrase_params("band", p, plane, slots, weights, T=T,
                           N_pad=N_pad, KV=KV, nblk=NB, len_code=len_code,
                           avg32=avg32, band=band, hit=hit.data_ptr(),
                           bkeys=bkeys.data_ptr() if listed else 0),
            dev, "phrase_band")
    launch_counts["phrase_band" + ("_tc" if mode == "tc" else "")] += 1
    return hit


def dense_pick(blockmax, slots, weights, *, T: int, NB: int, C: int,
               blockmax2=None, argpos=None):
    """_select_ub_blocks's outputs from the kernel, on CUDA tensors: (blk
    (B, C) int64 ascending block ids, next_ub (B,) f32). Checks the
    arguments as check_pick_inputs does, allocates the outputs (and the
    bounds' scratch and the parts' words, where the plan needs them) as
    views of one buffer, launches on the current stream and does not
    synchronize."""
    kw = dict(T=T, NB=NB, C=C, blockmax2=blockmax2, argpos=argpos)
    if not (pick_args_ok(blockmax, slots, weights, **kw)
            and blockmax.device.type == "cuda"):
        check_pick_inputs(blockmax, slots, weights, **kw)
        raise ValueError(f"dense_pick runs on CUDA tensors, got "
                         f"{blockmax.device}")
    dev = blockmax.device
    B = slots.shape[0]
    if B > MAX_B:
        raise ValueError(f"B = {B} queries exceed the grid's {MAX_B}")
    p = pick_plan(B, T, NB, C)
    # int64 ids first (8-byte aligned), then next_ub, the scratch and the
    # parts' words
    nb_pad = (B + 1) // 2 * 2
    buf = torch.empty(2 * B * C + nb_pad + p.scratch_words + p.done_words,
                      dtype=torch.int32, device=dev)
    blk = buf[: 2 * B * C].view(torch.int64).view(B, C)
    next_ub = buf[2 * B * C: 2 * B * C + B].view(torch.float32)
    if B == 0:
        return blk, next_ub
    base = buf.data_ptr()
    scratch = base + 4 * (2 * B * C + nb_pad)
    params = _PickParams(
        blockmax.data_ptr(), 0 if blockmax2 is None else blockmax2.data_ptr(),
        0 if argpos is None else argpos.data_ptr(), slots.data_ptr(),
        weights.data_ptr(), blockmax.shape[0], NB, B, T, C, p.nsplit,
        int(p.ub_smem), p.smem, scratch if p.scratch_words else 0,
        scratch + 4 * p.scratch_words if p.done_words else 0, base,
        base + 8 * B * C)
    _launch(lambda f: f.pick, params, dev, "dense_pick")
    launch_counts["dense_pick"] += 1
    return blk, next_ub
