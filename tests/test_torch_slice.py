"""The first slice of the port as a whole, on the CPU at the smoke size:
tune -> store -> serve, held against the JAX package's oracle, plus the
port's standing rules (no jax, no ``repro``, no silent CPU fallback).
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.dna_automaton.ref import fa_match_ref
from repro_torch.kernels import largest_aligned_divisor
from repro_torch.kernels.dna_automaton import ops
from repro_torch.tune import kernels as ktune

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def run_python(code_or_path, *, cwd=ROOT, timeout=300):
    args = [sys.executable, *([code_or_path] if isinstance(code_or_path, Path)
                              else ["-c", code_or_path])]
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.fixture
def tuned_path_disabled():
    yield
    ktune.disable()


def test_tune_store_serve_round_trip(tmp_path, tuned_path_disabled,
                                     monkeypatch):
    """tune_kernel measures within budget, a repeat measures nothing, and
    fa_match(tuned=True) answers requests at the stored launch parameters
    with zero new measurements and the reference oracle's counts."""
    store = tmp_path / "kernels.json"
    out = ktune.tune_kernel("dna_automaton", smoke=True, device="cpu",
                            store=store, repeats=1, iterations=80)
    assert out.space_size == 441
    assert 0 < out.n_measured <= 25 and out.measured_fraction <= 0.05
    assert out.timer.n_launch_failed == 0
    assert out.result.strategy == "SAML" and not out.result.from_cache
    assert out.result.n_training_experiments >= 4
    assert out.best_time() <= out.default_time()

    again = ktune.tune_kernel("dna_automaton", smoke=True, device="cpu",
                              store=store, repeats=1, iterations=80)
    assert again.result.from_cache and again.n_measured == 0
    assert again.best_config == out.best_config

    ktune.configure(store, device="cpu")
    seen = []
    real = ops._match

    def spy(text, table, accept, mc, cc, *rest):
        seen.append((mc, cc))
        return real(text, table, accept, mc, cc, *rest)

    monkeypatch.setattr(ops, "_match", spy)
    n_measured = out.timer.n_measured
    text = np.random.default_rng(21).integers(0, 4, 4096).astype(np.uint8)
    for motif in ("ACGTAC", "GATTAC", "TTAGGG", "ACGTACGT"):
        table, accept = ops.build_motif_dfa(motif)
        got = int(ops.fa_match(torch.from_numpy(text), table, accept,
                               tuned=True))
        want = int(fa_match_ref(jnp.asarray(text), jnp.asarray(table),
                                jnp.asarray(accept))[0])
        assert got == want, motif
    tuned = (out.best_config["map_chunk"], out.best_config["count_chunk"])
    # the defaults as fa_match clamps them to the text
    default = tuple(largest_aligned_divisor(4096, ops.DEFAULTS[k])
                    for k in ("map_chunk", "count_chunk"))
    # 6-letter motifs hit the record (same {"t", "s"}); the 8-letter one
    # (s = 9) misses and runs the hardcoded defaults
    assert seen == [tuned, tuned, tuned, default]
    assert out.timer.n_measured == n_measured


def test_store_file_is_keyed_by_device(tmp_path, tuned_path_disabled):
    store = tmp_path / "kernels.json"
    ktune.tune_kernel("dna_automaton", smoke=True, device="cpu", store=store,
                      strategy="random", iterations=2, repeats=1)
    entries = json.loads(store.read_text())["entries"]
    (entry,) = entries.values()
    assert entry["workload"] == {"kernel": "dna_automaton", "dtype": "uint8",
                                 "shape": {"s": 7, "t": 4096}}
    ktune.configure(store, device="cpu")
    meta = {"t": 4096, "s": 7}
    assert ktune.resolve_config("dna_automaton", meta, "uint8", device="cpu")
    assert ktune.resolve_config("dna_automaton", meta, "uint8",
                                device="cuda") == {}


SUBMODULES = sorted(
    ".".join(p.relative_to(PORT.parent).with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))


def test_every_submodule_is_listed():
    assert len(SUBMODULES) >= 24
    for name in ("repro_torch", "repro_torch._build", "repro_torch.convert",
                 "repro_torch.kernels.dna_automaton.kernel",
                 "repro_torch.tune.kernels.specs",
                 "repro_torch.runtime.store"):
        assert name in SUBMODULES


def test_importing_the_port_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"names = {SUBMODULES!r}\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "import repro_torch._build as b\n"
        "assert not b._loaded\n"
        "print('clean', len(names))\n")
    proc = run_python(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["clean", str(len(SUBMODULES))]


@pytest.mark.parametrize("path", [PORT, ROOT / "chip_smoke.py",
                                  ROOT / "examples"],
                         ids=["package", "chip_smoke", "examples"])
def test_no_source_imports_jax_or_repro(path):
    """The port's sources, and its twins of the examples
    (``examples/torch_*.py``), import neither JAX nor the reference."""
    files = [path] if path.is_file() else sorted(path.rglob(
        "torch_*.py" if path.name == "examples" else "*.py"))
    assert files
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    for f in files:
        assert not pat.search(f.read_text()), f
    for name in ("dna_automaton", "flash_attention", "flash_attention_bwd",
                 "decode_attention", "mamba_scan", "mamba_scan_bwd",
                 "rwkv6_wkv", "rwkv6_wkv_bwd"):
        assert (PORT / "kernels" / "csrc" / f"{name}.cu").exists()


@pytest.mark.parametrize("package, plain", [
    ("dna_automaton", ("state_map_plain", "count_hits_plain")),
    ("flash_attention", ("flash_attention_fwd_plain",
                         "flash_attention_bwd_plain")),
    ("decode_attention", ("decode_attention_plain",)),
    ("mamba_scan", ("selective_scan_fwd_plain", "selective_scan_bwd_plain")),
    ("rwkv6_wkv", ("wkv6_fwd_plain", "wkv6_bwd_plain")),
])
def test_no_silent_fallback_in_the_wrappers(package, plain):
    """For a CUDA tensor the wrapper launches the kernel or raises: the
    plain version is reachable only through the CPU branch."""
    src = (PORT / "kernels" / package / "kernel.py").read_text()
    assert "try:" not in src and "except" not in src
    for name in plain:
        # its def + the CPU branch
        assert src.count(f"{name}(") == 2, name
    assert src.count('.device.type == "cpu"') == len(
        [line for line in src.splitlines() if "launches += 1" in line])


def test_missing_compiler_raises_with_a_reason(tmp_path, monkeypatch):
    from repro_torch import _build

    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("needs a machine without the CUDA toolkit")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(_build.KernelBuildError, match="no kernel source"):
        _build.library_path("no_such_kernel")


def test_failed_build_raises_with_the_compilers_output(tmp_path, monkeypatch):
    from repro_torch import _build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: identifier undefined' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(_build.KernelBuildError, match="identifier undefined"):
        _build.load_library("dna_automaton")
    assert not list((tmp_path / "build").glob("*.so"))
    assert not list((tmp_path / "build").glob("*.tmp"))


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    from repro_torch import _build

    a = _build.library_path("dna_automaton")
    assert a.parent == ROOT / "build" and a.name.startswith("libdna_automaton-")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.library_path("dna_automaton") != a
    assert "compute_90a" in " ".join(_build.NVCC_FLAGS)


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    proc = run_python(ROOT / "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory that holds chip_smoke.py and nothing else of the
    repo the script must fail and print no result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env={"PATH": "/usr/bin:/bin"}, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
