"""wiser_tpu_torch — the PyTorch / CUDA port of wiser_tpu for NVIDIA Hopper.

A second package beside the JAX one: it serves the same PackedIndex and
must return the same (doc, f64 score) lists. It imports torch and never
jax, and nothing of wiser_tpu: it keeps its own copy of the host modules
it needs (types, scoring, codecs, bloom probes, index format and
builder, corpus generator, engine/topk, native codecs), and convert.py
carries an index across from the JAX package.

Ported so far: the resident serving path (TorchEngine, raw columns):
single-term, AND and phrase queries, with the dense head-term tier
(dense, semidense and block-max pruned scans and the batched rescue) and
the phrase routes (bi-bloom gated list chain and compact route,
semidense phrase, full-scan mega phrase with its rescue); and the staged
engine's device cold path for non-phrase queries, with the packed-block
decode as a hand-written CUDA kernel (ops/unpack.py, csrc/unpack.cu).
Entry points run on the card unless the caller passes device="cpu".
"""

from wiser_tpu_torch.engine.device import TorchEngine
from wiser_tpu_torch.engine.staged import StagedEngine
from wiser_tpu_torch.runtime import resolve_device

__all__ = ["TorchEngine", "StagedEngine", "resolve_device"]
