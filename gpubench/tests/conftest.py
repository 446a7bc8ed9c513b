"""The benchmark's own tests, on the CPU at tiny widths.

``tiny_tree`` copies the benchmark's data files into a temporary folder
and cuts every configuration and traffic mix down to what a CPU test can
run (the kernels' plain PyTorch versions); ``BENCH`` is ``BENCHMARK.json``
as committed.  Tests that need the card carry the ``card`` marker and skip
inside the test where there is none.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TRAIN = "rwkv6-1.6b.train.24x2048"
PREFILL = "qwen2.5-3b.prefill.4k-32k"

TINY_ARCH = {
    "rwkv6-1.6b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       head_dim=16, d_ff=128, vocab_size=256,
                       layer_kinds=["rwkv"] * 2,
                       rwkv={"head_dim": 16, "lora_rank_mix": 8,
                             "lora_rank_decay": 8}),
    "qwen2.5-3b": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                       head_dim=32, d_ff=256, vocab_size=256),
}
TINY_MIX = {
    "train.24x2048": dict(batch=2, seq_len=40),
    "prefill.4k-32k": dict(lengths=[16, 32, 64], answer_tokens=4,
                           batch_tokens=64, requests_per_length=4,
                           traced_units=7),
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips where there is none")


def edit(path: Path, **changes) -> None:
    data = json.loads(path.read_text())
    data.update(changes)
    path.write_text(json.dumps(data))


def make_tiny_tree(dst: Path) -> Path:
    shutil.copytree(ROOT / "gpubench", dst,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, arch in TINY_ARCH.items():
        path = dst / "configs" / f"{name}.json"
        data = json.loads(path.read_text())
        data["arch"].update(arch)
        path.write_text(json.dumps(data))
    for name, mix in TINY_MIX.items():
        edit(dst / "traffic" / f"{name}.json", **mix)
    return dst


@pytest.fixture
def tiny_tree(tmp_path) -> Path:
    return make_tiny_tree(tmp_path / "gpubench")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no NVIDIA card here: runs on the chip")
