"""Nothing the benchmark runs loads JAX or the JAX package (``repro``,
compared by whole top-level name: ``repro_torch`` is the port), the
references load not even the port, and no source names the JAX package's
CPU benchmarks."""

import subprocess
import sys

from conftest import ROOT
from gpubench import imports


def test_sources_are_clean():
    assert imports.scan() == []


def test_scan_finds_planted_breaches(tiny_tree):
    (tiny_tree / "metrics" / "bad.train.py").write_text(
        "import jax.numpy as jnp\nfrom repro.models import lm\n")
    (tiny_tree / "reference" / "bad.py").write_text(
        "from repro_torch.models import lm\n")
    (tiny_tree / "traffic" / "bad.py").write_text(
        "PATH = 'BENCH_serve.json'\n")
    found = "\n".join(imports.scan(tiny_tree))
    for what in ("imports jax", "imports repro", "reference/bad.py: imports "
                 "repro_torch", "BENCH_serve.json"):
        assert what in found
    assert imports.top_level("repro_torch.models") != "repro"


def test_a_run_loads_neither(tiny_tree):
    """A whole run (CPU, tiny), every metric and reference loaded: no
    forbidden top-level module in ``sys.modules`` after it."""
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import json
from gpubench import harness, imports, readings
from gpubench.reference import dense, rwkv6
bench = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
from pathlib import Path
for name in ("rwkv6-1.6b.train.24x2048", "qwen2.5-3b.prefill.4k-32k"):
    harness.run_cell(name, 1, 0.2, True, device="cpu", bench=bench,
                     root=Path({str(tiny_tree)!r}))
print("LOADED", imports.loaded())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
