"""wiser_tpu_torch — the PyTorch / CUDA port of wiser_tpu for NVIDIA Hopper.

A second package beside the JAX one: it serves the same PackedIndex and
must return the same (doc, f64 score) lists. It imports torch and never
jax, and nothing of wiser_tpu: it keeps its own copy of the host modules
it needs (types, scoring, codecs, bloom probes, index format and
builder, corpus generator, engine/topk, native codecs), and convert.py
carries an index across from the JAX package.

Ported so far: the single-card engines (TorchEngine, StagedEngine; raw
and tc columns): single-term, AND and phrase queries over every route of
the JAX engines, with snippets from the document bodies, and the staged
cold path's packed-block decode as a hand-written CUDA kernel
(ops/unpack.py, csrc/unpack.cu); the doc-built index (data/synth.py,
oracle.py, index/builder.py, index/oracle_dump.py, the doc stores); and
the serving entry points: bench/headline.py (bench.py's headline), the
engine factory, and serve/ (the batching executor, the gRPC server and
its client); and what measures and operates the engines: utils.py
(timers, torch.profiler traces), data/synth_log.py, bench/run_exp.py
(the memory grid) and tools/ (the scale ladder, route profile, strict
parity audit, stage probe, indexer, index checks, query logs, engine
bench, client-server runner); and the mesh (engine/shard.py,
engine/staged_shard.py: the doc-partitioned engines, one device per
shard; tools/shard_ladder.py, tools/dryrun_multichip.py). Entry points
run on the card unless the caller passes device="cpu".
"""

from wiser_tpu_torch.engine.device import TorchEngine
from wiser_tpu_torch.engine.staged import StagedEngine
from wiser_tpu_torch.runtime import resolve_device

__all__ = ["TorchEngine", "StagedEngine", "resolve_device"]
