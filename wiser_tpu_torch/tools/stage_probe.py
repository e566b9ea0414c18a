"""Per-stage device time of the pruned dense scan on tc columns (the port's
copy of wiser_tpu/tools/stage_probe.py) — the route of the slowest
all-head mixes (zipf_t3 / t4, dense_t3, dense_all_head_pair).

The scan (kernels.pruned_scan_body) is three stages:
  S1 block select: the per-block upper bound over (B, NB) and the top
     C+1 pick (kernels._select_ub_blocks: on a card the dense_pick
     kernel of ops/dense.py, on the CPU its plain version; `s1_pick`
     says which); also the bound alone, in plain torch;
  S2 payload: the (B, T, C, 128) gathers of the uint8 tf plane and the
     shared len-code row, composed to tc lanes and scored (tc_score),
     in plain torch; beside it the fused block-list scan over the same
     picked blocks, payload and top-M in one (on a card the dense_scan
     kernel, on the CPU the plain payload stage and its top-M;
     `s2_fused` says which);
  S3 the final top-M and the guard flags (the whole kernel),
plus two top-k isolates (C+1 of NB blocks, M of C*128 lanes), and a
two-level block select: superblock maxima of SB blocks, top C/SB of
them, expanded — with the prune-guard flag rate its coarser bound costs.
Each prefix is timed over `reps` calls after a warm call: CUDA events on
a card, the host clock on the CPU.

Run: python -m wiser_tpu_torch.tools.stage_probe --index <dir> \
         [--B 512 --T 3 --C 512 --M 16 --SB 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_call(fn, *args, device, reps: int = 4) -> float:
    """Mean seconds of fn(*args) over reps calls, after one warm call."""
    from wiser_tpu_torch.utils import device_timer

    start, stop = device_timer(device)
    fn(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t = start()
    for _ in range(reps):
        fn(*args)
    return stop(t) / reps


def probe(eng, packed, B: int = 512, T: int = 3, C: int = 512, M: int = 16,
          SB: int = 8, reps: int = 4, seed: int = 5) -> dict:
    """The stage times of `eng` (a TorchEngine on tc columns with a dense
    tier) at B queries of T all-head terms (Zipf draws over the df-ranked
    dense rows), C blocks, M lanes. Times in ms."""
    from wiser_tpu_torch.engine import kernels as K
    from wiser_tpu_torch.ops import dense as D

    if not eng.tc or not eng._dense_H:
        raise ValueError("stage_probe needs a tc TorchEngine with a dense tier")
    dev = eng.device
    NB = eng._n_pad_docs // 128
    eps3 = 3.0 * eng.rel_eps
    log(f"NB={NB} B={B} T={T} C={C} M={M} SB={SB}")

    # all-head conjunctions: Zipf draws over df rank among the dense rows
    rng = np.random.default_rng(seed)
    order = np.argsort(packed.df)[::-1]
    dense_rows = order[np.asarray(
        [eng._dense_slot[r] >= 0 for r in order])][:2048]
    ranks = np.minimum(rng.zipf(1.25, size=(B, T)) - 1, len(dense_rows) - 1)
    rows = dense_rows[ranks]
    slots = eng._dense_slot[rows].astype(np.int32)
    idf32 = packed.idf64[rows].astype(np.float32)
    d_slots = torch.from_numpy(slots).to(dev)
    d_idf = torch.from_numpy(idf32).to(dev)
    d_ks = torch.full((B,), 10, dtype=torch.int32, device=dev)
    bm, bm2, ap = (eng.d_dense_blockmax, eng.d_dense_blockmax2,
                   eng.d_dense_argpos)

    def weights_of(idf):
        return (idf > 0).to(torch.float32)

    def s1_select(slots, idf):
        blk, next_ub = K._select_ub_blocks(
            bm, slots, weights_of(idf), T=T, NB=NB, C=C, blockmax2=bm2,
            argpos=ap)
        return blk.sum() + next_ub.sum().to(torch.int64)

    def ub_only(slots, idf):
        """The bound of _select_ub_blocks without its top-k."""
        weights = weights_of(idf)
        r = slots.to(torch.int64)
        feas = torch.ones((B, NB), dtype=torch.bool, device=dev)
        bms, bm2s, aps = [], [], []
        for t in range(T):
            b = bm[r[:, t]]
            w = weights[:, t : t + 1]
            bms.append(b * w)
            feas &= (b > 0.0) | (w == 0.0)
            bm2s.append(bm2[r[:, t]] * w)
            aps.append(ap[r[:, t]])
        ub = torch.full((B, NB), K.NEG_INF, dtype=torch.float32, device=dev)
        for ts in range(T):
            bound = bms[ts]
            for t in range(T):
                if t != ts:
                    bound = bound + torch.where(aps[t] == aps[ts],
                                                bms[t], bm2s[t])
            ub = torch.maximum(ub, bound)
        return torch.where(feas, ub, 0.0)

    def s1_ub_only(slots, idf):
        return ub_only(slots, idf).sum()

    tf_rows = eng.d_dense_tf8.view(-1, 128)  # uint8: gathered unwidened
    len_rows = eng.d_len_code.view(NB, 128)

    def payload_score(slots, idf, blk):
        score = torch.zeros((B, blk.shape[1], 128), dtype=torch.float32,
                            device=dev)
        match = torch.ones_like(score, dtype=torch.bool)
        r = slots.to(torch.int64)
        code = len_rows[blk].to(torch.int32) << 8
        for t in range(T):
            tf = tf_rows[r[:, t : t + 1] * NB + blk].to(torch.int32)
            p = torch.where(tf > 0, code | tf, 0)
            match &= p > 0
            score += K.tc_score(p, idf[:, t, None, None], eng.d_avg32)
        return torch.where(match, score, K.NEG_INF).reshape(B, -1)

    def s2_payload(slots, idf):
        blk, _ = K._select_ub_blocks(
            bm, slots, weights_of(idf), T=T, NB=NB, C=C, blockmax2=bm2,
            argpos=ap)
        return payload_score(slots, idf, blk).sum()

    on_card = torch.device(dev).type == "cuda"

    def s2_fused(slots, idf, blk):
        """The block-list scan over the picked blocks: the fused kernel
        on a card, the plain payload stage and its top-M on the CPU."""
        if on_card:
            return D.dense_scan(
                eng.d_dense_tf8, None, slots, idf, T=T, N_pad=NB * 128, M=M,
                blocks=blk, len_code=eng.d_len_code,
                avg32=eng.d_avg32)[1].sum()
        return torch.topk(payload_score(slots, idf, blk), M, dim=1)[0].sum()

    kern = K.make_pruned_dense_kernel_tc(T, NB, C, M, eps3)

    def full_kernel(slots, idf, ks):
        return kern(eng.d_dense_tf8, eng.d_len_code, eng.d_avg32, bm, bm2,
                    ap, slots, idf, ks)

    def topk_blocks(x):
        s, i = torch.topk(x, C + 1, dim=1)
        return s.sum() + i.sum()

    def topk_lanes(x):
        s, i = torch.topk(x, M, dim=1)
        return s.sum() + i.sum()

    # two-level select: superblock maxima -> top CS -> expand
    NSB = -(-NB // SB)  # the tail superblock padded with bound 0
    CS = max(C // SB, 1)

    def select_two_level(slots, idf):
        ub = ub_only(slots, idf)
        if NSB * SB != NB:
            ub = torch.nn.functional.pad(ub, (0, NSB * SB - NB))
        sb_ub = ub.view(B, NSB, SB).amax(dim=2)
        top_ub, top_i = torch.topk(sb_ub, CS + 1, dim=1)
        sb, _ = torch.sort(top_i[:, :CS], dim=1)
        lane = torch.arange(SB, dtype=torch.int64, device=dev)
        blk = (sb[:, :, None] * SB + lane).reshape(B, CS * SB)
        return blk.clamp(max=NB - 1), top_ub[:, CS]

    def s1_two_level(slots, idf):
        blk, next_ub = select_two_level(slots, idf)
        return blk.sum() + next_ub.sum().to(torch.int64)

    def full_two_level(slots, idf, ks):
        blk, next_ub = select_two_level(slots, idf)
        top_score, _ = torch.topk(payload_score(slots, idf, blk), M, dim=1)
        flag = K.prune_guard_flag(top_score, next_ub, ks, M=M, eps3=eps3)
        return top_score.sum(), flag

    rnd_blocks = torch.from_numpy(
        rng.random((B, NB), dtype=np.float32)).to(dev)
    rnd_lanes = torch.from_numpy(
        rng.random((B, C * 128), dtype=np.float32)).to(dev)

    def ms(fn, *args):
        return 1e3 * time_call(fn, *args, device=dev, reps=reps)

    res = {"NB": int(NB), "B": B, "T": T, "C": C, "M": M, "SB": SB,
           "device": str(dev), "reps": reps,
           "s1_pick": ("dense_pick kernel" if on_card
                       else "plain torch (_select_ub_blocks_torch)"),
           "s2_fused": ("dense_scan kernel" if on_card
                        else "plain torch (payload stage + top-M)")}
    res["s1_ub_only_ms"] = ms(s1_ub_only, d_slots, d_idf)
    res["s1_select_ms"] = ms(s1_select, d_slots, d_idf)
    res["s1_two_level_ms"] = ms(s1_two_level, d_slots, d_idf)
    res["s2_payload_ms"] = ms(s2_payload, d_slots, d_idf)
    picked = K._select_ub_blocks(bm, d_slots, weights_of(d_idf), T=T, NB=NB,
                                 C=C, blockmax2=bm2, argpos=ap)[0]
    res["s2_fused_scan_ms"] = ms(s2_fused, d_slots, d_idf, picked)
    res["full_ms"] = ms(full_kernel, d_slots, d_idf, d_ks)
    res["full_two_level_ms"] = ms(full_two_level, d_slots, d_idf, d_ks)
    res["topk_blocks_ms"] = ms(topk_blocks, rnd_blocks)
    res["topk_lanes_ms"] = ms(topk_lanes, rnd_lanes)

    # the prune-guard flag rate of the exact and the two-level bound
    flags_exact = full_kernel(d_slots, d_idf, d_ks)[:, T + 1, 0].cpu().numpy()
    flags_2l = full_two_level(d_slots, d_idf, d_ks)[1].cpu().numpy()
    res["flag_rate_exact"] = float(
        ((flags_exact & K.FLAG_PRUNE_MISS) != 0).mean())
    res["flag_rate_two_level"] = float((flags_2l != 0).mean())
    res["per_query_us_full"] = 1e3 * res["full_ms"] / B
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--index", required=True)
    ap.add_argument("--B", type=int, default=512)
    ap.add_argument("--T", type=int, default=3)
    ap.add_argument("--C", type=int, default=512)
    ap.add_argument("--M", type=int, default=16)
    ap.add_argument("--SB", type=int, default=8,
                    help="two-level superblock size (blocks)")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from wiser_tpu_torch.engine.device import TorchEngine
    from wiser_tpu_torch.index.format import PackedIndex

    packed = PackedIndex.load(args.index, skip_offsets=True)
    eng = TorchEngine(packed, device=args.device, columns="tc")
    res = probe(eng, packed, args.B, args.T, args.C, args.M, args.SB,
                args.reps)
    for k, v in res.items():
        log(f"  {k}: {v}")
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
