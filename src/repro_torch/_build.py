"""Build the CUDA sources under ``kernels/csrc/`` and load them with ctypes.

Each ``<name>.cu`` there has a plain C interface (no PyTorch headers, so
it compiles in seconds).  ``load_library(name)`` compiles it once with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

into ``build/lib<name>-<hash>.so`` (the hash covers the source, the
headers beside it and the flags, so an edited source is rebuilt and an
unchanged one is reused) and
returns the ``ctypes.CDLL``; ptxas's report of registers, shared memory
and spills is kept beside it (``build_log``).  ``load_libraries`` builds
several sources at once, one ``nvcc`` each, all started together.
Nothing is compiled when this module is imported; the first launch of a
kernel pays for the build.

A failed build raises :class:`KernelBuildError` carrying the compiler's
output.  There is no fallback: a caller holding a CUDA tensor either
gets the kernel or the error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC_DIR", "KernelBuildError", "NVCC_FLAGS", "build_dir",
           "build_log", "find_nvcc", "library_path", "load_libraries",
           "load_library"]

CSRC_DIR = Path(__file__).resolve().parent / "kernels" / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source; the message has its output."""


def build_dir() -> Path:
    """``build/`` at the root of the checkout (``src/``'s parent)."""
    return Path(__file__).resolve().parents[2] / "build"


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (looked on PATH, in $CUDA_HOME, $CUDA_PATH and "
        "/usr/local/cuda): the CUDA kernels cannot be built here")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    if not src.exists():
        raise KernelBuildError(f"no kernel source {src}")
    # the headers a source may include live beside it: an edited header
    # rebuilds every library
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def _start(name: str) -> tuple[subprocess.Popen, list[str], Path, Path]:
    """Start ``nvcc`` on ``kernels/csrc/<name>.cu``; returns the process,
    its command, the temporary output and the library path."""
    out = library_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, cmd, tmp, out


def _finish(name: str, proc: subprocess.Popen, cmd: list[str], tmp: Path,
            out: Path) -> str | None:
    """Wait for one ``nvcc``; the error message if it failed, else None."""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    # ptxas's report (registers, shared memory, spills per kernel)
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(tmp, out)
    return None


def load_libraries(names) -> dict[str, ctypes.CDLL]:
    """Compile every missing library of ``names`` at once (one ``nvcc``
    each, all started together) and load them all."""
    names = list(dict.fromkeys(names))
    started = [(name, *_start(name)) for name in names
               if name not in _loaded and not library_path(name).exists()]
    errors = [_finish(*job) for job in started]    # wait for every nvcc
    failed = [e for e in errors if e is not None]
    if failed:
        raise KernelBuildError("\n\n".join(failed))
    for name in names:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return {name: _loaded[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``kernels/csrc/<name>.cu`` if needed and load it."""
    return load_libraries([name])[name]


def build_log(name: str) -> str:
    """What ``nvcc -Xptxas -v`` reported when the library was built."""
    return library_path(name).with_suffix(".log").read_text()
