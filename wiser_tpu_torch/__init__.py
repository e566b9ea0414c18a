"""wiser_tpu_torch — the PyTorch / CUDA port of wiser_tpu for NVIDIA Hopper.

A second package beside the JAX one: it reads the same PackedIndex and
must return the same (doc, f64 score) lists. It imports torch and never
jax; the JAX-free host modules of wiser_tpu (types, scoring, index
format and builders, oracle, engine/topk, native codecs) are shared.

Ported so far: the conjunctive serving path (TorchEngine, raw columns)
and the staged engine's device cold path with the packed-block decode as
a hand-written CUDA kernel (ops/unpack.py, csrc/unpack.cu).
"""

from wiser_tpu_torch.engine.device import TorchEngine
from wiser_tpu_torch.engine.staged import StagedEngine
from wiser_tpu_torch.runtime import resolve_device

__all__ = ["TorchEngine", "StagedEngine", "resolve_device"]
