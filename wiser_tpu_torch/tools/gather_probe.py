"""Micro-probe: the semidense route's doc-indexed gather against three
reformulations, on a device (the port's copy of
wiser_tpu/tools/gather_probe.py).

The semidense step's per-lane membership test is one element gather into
a (H, N_pad) dense row per dense other term (kernels._semidense_step
through _dense_gather). On the TPU this probe was written for, element
gathers were slow next to 128-wide row gathers (a TPU reading, not this
port's); this probe measures the same four forms on the card before any
Hopper form of the step is written:

  element          the step's gather as it is (the baseline)
  rowgather_onehot gather each lane's 128-doc block, select the lane with
                   a one-hot contraction (an einsum)
  rowgather_local  gather each lane's 128-doc block, select with
                   take_along_dim
  blocksum_gather  no per-lane gather of the row: a sum over every
                   128-doc block of the row, then a gather of the block
                   sums (the dense scan's shape; another function, a
                   cost model only)

The first three compute the same function and must agree bit for bit
(the one-hot sum has one nonzero term). Each is timed with CUDA events
after a warm launch on a card (the host clock on the CPU, labelled so),
beside the least time the card could take: the bytes the function must
move (the row, the doc ids and the output, each once) over 3.35 TB/s.

Run: python -m wiser_tpu_torch.tools.gather_probe [--n-pad 1000448] \
         [--B 128] [--L 8192] [--reps 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# H100 SXM HBM3 rate (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def element(dense: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """dense (N,) f32, docs (B, L) int32 -> dense[docs] (B, L)."""
    return dense[docs.to(torch.int64)]


def rowgather_onehot(dense: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    blocks = dense.reshape(-1, 128)
    w = blocks[(docs >> 7).to(torch.int64)]  # (B, L, 128) row gathers
    oh = ((docs & 127)[..., None] == torch.arange(
        128, dtype=docs.dtype, device=docs.device)).to(torch.float32)
    return torch.einsum("blk,blk->bl", w, oh)


def rowgather_local(dense: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    blocks = dense.reshape(-1, 128)
    w = blocks[(docs >> 7).to(torch.int64)]
    off = (docs & 127).to(torch.int64)[..., None]
    return torch.take_along_dim(w, off, dim=2)[..., 0]


def blocksum_gather(dense: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    s = dense.reshape(-1, 128).sum(dim=1)
    return s[(docs >> 7).to(torch.int64)]


VARIANTS = {"element": element, "rowgather_onehot": rowgather_onehot,
            "rowgather_local": rowgather_local,
            "blocksum_gather": blocksum_gather}


def make_inputs(n_pad: int, B: int, L: int, seed: int = 0):
    """The probe's numpy inputs: a (n_pad,) f32 row in [0, 1) and (B, L)
    int32 doc ids ascending per row (the semidense candidate layout)."""
    if n_pad % 128:
        raise ValueError(f"n_pad {n_pad} is not a multiple of 128")
    rng = np.random.default_rng(seed)
    dense = rng.random((n_pad,), dtype=np.float32)
    docs = np.sort(rng.integers(0, n_pad, size=(B, L)), axis=1).astype(np.int32)
    return dense, docs


def _time_ms(fn, reps: int, device: torch.device) -> float:
    fn()  # warm
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def probe(n_pad: int, B: int, L: int, reps: int, device="cuda") -> dict:
    """Every variant's time, lane rate and bytes bound; raises unless the
    three gathers of the same function agree bit for bit."""
    from wiser_tpu_torch.runtime import resolve_device

    dev = resolve_device(device)
    dense_np, docs_np = make_inputs(n_pad, B, L)
    dense = torch.from_numpy(dense_np).to(dev)
    docs = torch.from_numpy(docs_np).to(dev)
    outs = {name: fn(dense, docs) for name, fn in VARIANTS.items()}
    ref = outs["element"].cpu().numpy()
    for name in ("rowgather_onehot", "rowgather_local"):
        got = outs[name].cpu().numpy()
        if not np.array_equal(got.view(np.uint32), ref.view(np.uint32)):
            raise AssertionError(f"{name} differs from element")
    del outs
    lanes = B * L
    # the function's bytes: the row, the doc ids and the output, once each
    bound_ms = (4 * n_pad + 8 * lanes) / HBM_BYTES_PER_S * 1e3
    rows = {}
    for name, fn in VARIANTS.items():
        ms = _time_ms(lambda: fn(dense, docs), reps, dev)
        rows[name] = {"ms": ms, "G_lanes_per_s": lanes / (ms * 1e-3) / 1e9,
                      "bound_ms": bound_ms, "bound_share": bound_ms / ms}
        log(f"{name}: {ms:.4f} ms ({rows[name]['G_lanes_per_s']:.2f} G "
            f"lane/s; bound {bound_ms:.4f} ms)")
    return {"device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "clock": "cuda_events" if dev.type == "cuda" else "host",
            "n_pad": n_pad, "B": B, "L": L, "reps": reps,
            # the (B, L, 128) f32 blocks the row-gather forms materialize
            "rowgather_intermediate_bytes": 4 * 128 * lanes,
            "bit_exact": True, "variants": rows}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-pad", type=int, default=1_000_448)
    ap.add_argument("--B", type=int, default=128)
    ap.add_argument("--L", type=int, default=8192)
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = probe(args.n_pad, args.B, args.L, args.reps, args.device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
