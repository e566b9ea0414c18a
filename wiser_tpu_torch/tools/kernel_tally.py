"""Each hand-written kernel's device ms summed over a run's launches.

While a `KernelTally` is installed (`with KernelTally() as tally:`), every
call of a kernel wrapper (ops/search.bs_search, ops/dense.dense_scan,
dense_pick, phrase_select and phrase_band, ops/semidense.semidense,
ops/phrase.phrase_verify_docs, ops/phrase_route.semidense_phrase,
list_phrase and compact_phrase; in an older tree the bag-bound
ops/phrase.phrase_verify too) is counted by its
kernel's name (`_tc` on tc columns; the list chain without its gate, the
mesh's list route, as `list_phrase_nogate`) and
its call shape (every tensor argument's shape and dtype, every other
argument's value), and the newest call of each shape is kept. `flush`
(called before the engine whose tensors those calls hold goes away)
times each kept call on the card (tools/search_bench.queued_ms: CUDA
events around calls queued behind a sleep kernel, so the wrapper's host
cost does not enter the device time) and adds calls x ms of each shape
to its kernel's sum; the
kept calls are then dropped. The sums estimate the device time the run's
launches took (the newest call stands for its shape's others, whose data
differed); the timing launches are not counted: every launch count is
restored after them. A tc wrapper's sum includes its table launch
(ops/dense.tc_table).

The torch steps a kernel replaced are tallied the same way where a tree
still runs them (TORCH_STEPS), so two trees' sums cover the same work:
the mega routes' posting-index recovery before their verification
(engine/kernels._binary_search and the two pos_starts _gather1d reads,
called from _full_phrase_run or _pruned_phrase_body on a card), which
phrase_verify_docs does inside its kernel, is `phrase_recovery_torch`
(its launches: each call's torch launches, n_iters halvings of about 6
each for a search, 1 for a gather).
"""

from __future__ import annotations

import importlib

# (module, wrapper, kernel name, the argument whose rows are the group's
# queries): the wrappers the engines call through their module attributes
WRAPPERS = (
    ("wiser_tpu_torch.ops.search", "bs_search", "bs_search", 3),
    ("wiser_tpu_torch.ops.dense", "dense_scan", "dense_scan", 2),
    ("wiser_tpu_torch.ops.dense", "dense_pick", "dense_pick", 1),
    ("wiser_tpu_torch.ops.dense", "phrase_select", "phrase_select", 1),
    ("wiser_tpu_torch.ops.dense", "phrase_band", "phrase_band", 1),
    ("wiser_tpu_torch.ops.semidense", "semidense", "semidense", 3),
    ("wiser_tpu_torch.ops.phrase", "phrase_verify", "phrase_verify", 1),  # older
    ("wiser_tpu_torch.ops.phrase", "phrase_verify_docs",
     "phrase_verify_docs", 3),
    ("wiser_tpu_torch.ops.phrase_route", "semidense_phrase",
     "semidense_phrase", 5),
    ("wiser_tpu_torch.ops.phrase_route", "list_phrase", "list_phrase", 4),
    ("wiser_tpu_torch.ops.phrase_route", "compact_phrase", "compact_phrase",
     4),
)
_TC_KW = ("avg32", "len_code", "tc")
# (module, torch step, name, callers, torch launches a call: a function
# of the call's arguments): torch steps that a kernel replaced, tallied
# where the named callers still run them on CUDA tensors
TORCH_STEPS = (
    ("wiser_tpu_torch.engine.kernels", "_binary_search",
     "phrase_recovery_torch", ("_full_phrase_run", "_pruned_phrase_body"),
     lambda args, kw: 6 * int(args[4] if len(args) > 4
                              else kw["n_iters"])),
    ("wiser_tpu_torch.engine.kernels", "_gather1d", "phrase_recovery_torch",
     ("_full_phrase_run", "_pruned_phrase_body"), lambda args, kw: 1),
)


def _sig(x):
    import torch

    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), str(x.dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_sig(v) for v in x)
    return x


class KernelTally:
    """Counts and keeps the wrappers' calls while installed; `flush`
    times them and adds to `sums` under a label (a smoke phase): per
    kernel its launches, summed ms and each shape's row (B, the integer
    arguments, calls, ms a call)."""

    def __init__(self, iters: int = 3):
        self.iters = iters
        # (name, signature) -> [count, fn, args, kw, shape]
        self.calls = {}
        self.sums = {}  # label -> name -> {launches, ms, shapes}
        self._orig = []

    def __enter__(self):
        for mod_name, attr, base, b_arg in WRAPPERS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:  # a tree without this kernel
                continue
            self._orig.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, base, b_arg))
        for mod_name, attr, name, callers, launches in TORCH_STEPS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self._orig.append((mod, attr, fn))
            setattr(mod, attr, self._wrap_step(fn, name, callers, launches))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._orig:
            setattr(mod, attr, fn)
        self._orig.clear()
        return False

    def _wrap(self, fn, base, b_arg):
        def run(*args, **kw):
            name = (base + ("_nogate" if kw.get("gate") is False else "")
                    + ("_tc" if any(kw.get(k) is not None
                                    for k in _TC_KW) else ""))
            key = (name, _sig(args), _sig(tuple(sorted(kw.items()))))
            entry = self.calls.get(key)
            if entry is None:
                shape = {"B": int(args[b_arg].shape[0]),
                         **{k: v for k, v in kw.items()
                            if type(v) is int}}
                self.calls[key] = [1, fn, args, kw, shape]
            else:
                entry[0] += 1
                entry[2], entry[3] = args, kw
            return fn(*args, **kw)
        return run

    def _wrap_step(self, fn, name, callers, launches):
        import sys

        def run(*args, **kw):
            if (sys._getframe(1).f_code.co_name in callers
                    and getattr(args[1], "is_cuda", False)):
                key = (name, fn.__name__, _sig(args),
                       _sig(tuple(sorted(kw.items()))))
                entry = self.calls.get(key)
                if entry is None:
                    shape = {"B": int(args[1].shape[0]), "step": fn.__name__,
                             "launches_a_call": launches(args, kw)}
                    self.calls[key] = [1, fn, args, kw, shape]
                else:
                    entry[0] += 1
                    entry[2], entry[3] = args, kw
            return fn(*args, **kw)
        return run

    def flush(self, label: str) -> dict:
        """Time every kept call (queued_ms over `iters` calls) and add
        calls x ms to label's sums; returns them."""
        from wiser_tpu_torch.ops import (dense, phrase, phrase_route, search,
                                         semidense)
        from wiser_tpu_torch.tools.search_bench import queued_ms

        counts = [m.launch_counts for m in (dense, phrase, phrase_route,
                                            search, semidense)]
        saved = [dict(c) for c in counts]
        out = self.sums.setdefault(label, {})
        try:
            for (name, *_), (n, fn, args, kw, shape) in self.calls.items():
                ms = queued_ms(lambda: fn(*args, **kw), self.iters)
                row = out.setdefault(name, {"launches": 0, "ms": 0.0,
                                            "by_shape": []})
                row["launches"] += n * shape.get("launches_a_call", 1)
                row["ms"] += n * ms
                row["by_shape"].append(dict(shape, calls=n, ms=ms))
        finally:
            for c, s in zip(counts, saved):
                c.clear()
                c.update(s)
            self.calls.clear()
        return out

    def totals(self) -> dict:
        """Each kernel's launches and summed ms over every label."""
        tot = {}
        for rows in self.sums.values():
            for name, r in rows.items():
                t = tot.setdefault(name, {"launches": 0, "ms": 0.0})
                t["launches"] += r["launches"]
                t["ms"] += r["ms"]
        return dict(sorted(tot.items(), key=lambda kv: -kv[1]["ms"]))
