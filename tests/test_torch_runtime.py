"""Device selection and import hygiene of wiser_tpu_torch: CUDA requested
where there is none raises (no silent CPU fallback); the package runs
without importing jax; chip_smoke.py refuses to run without a card."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.index.builder import build_index
from wiser_tpu_torch import StagedEngine, TorchEngine, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    packed, _ = build_index(synth_docinfos(50, 20, 10, seed=1))
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        TorchEngine(packed, device="cuda")
    with pytest.raises(RuntimeError):
        StagedEngine(packed, 0, device="cuda")


def test_unknown_device_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


_NO_JAX = """
import sys
sys.path.insert(0, {root!r})
from wiser_tpu.data.synth import synth_docinfos
from wiser_tpu.index.builder import build_index
from wiser_tpu.types import SearchQuery
from wiser_tpu_torch import StagedEngine, TorchEngine
import wiser_tpu_torch.build, wiser_tpu_torch.shared

packed, oracle = build_index(synth_docinfos(200, 40, 20, seed=3))
qs = [SearchQuery(["t0", "t1"], n_results=5), SearchQuery(["t2"], n_results=5)]
want = [[(e.doc_id, e.doc_score) for e in oracle.search(q).entries] for q in qs]
staged = StagedEngine(packed, 0, device="cpu")
staged.COLD_COMPUTE = "device"
for eng in (TorchEngine(packed, device="cpu"), staged):
    got = [[(e.doc_id, e.doc_score) for e in r.entries]
           for r in eng.search_batch(qs)]
    assert got == want, (got, want)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m in ("wiser_tpu.engine.device", "wiser_tpu.engine.kernels",
                      "wiser_tpu.engine.staged", "wiser_tpu.ops.unpack"))
assert not bad, bad
print("OK")
"""


def test_port_never_imports_jax():
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    out = subprocess.run([sys.executable, "-c", _NO_JAX.format(root=ROOT)],
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")


def _smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:  # chip_smoke.py alone, without the program
            shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        out = _smoke(cwd)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
