"""wiser_tpu_torch — the PyTorch / CUDA port of wiser_tpu for NVIDIA Hopper.

A second package beside the JAX one: it serves the same PackedIndex and
must return the same (doc, f64 score) lists. It imports torch and never
jax, and nothing of wiser_tpu: it keeps its own copy of the host modules
it needs (types, scoring, codecs, index format and builder, corpus
generator, engine/topk, native codecs), and convert.py carries an index
across from the JAX package.

Ported so far: the conjunctive serving path (TorchEngine, raw columns,
with the dense head-term tier: dense, semidense and block-max pruned
scans and the batched rescue) and the staged engine's device cold path
with the packed-block decode as a hand-written CUDA kernel
(ops/unpack.py, csrc/unpack.cu). Entry points run on the card unless
the caller passes device="cpu".
"""

from wiser_tpu_torch.engine.device import TorchEngine
from wiser_tpu_torch.engine.staged import StagedEngine
from wiser_tpu_torch.runtime import resolve_device

__all__ = ["TorchEngine", "StagedEngine", "resolve_device"]
