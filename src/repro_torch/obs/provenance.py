"""Run provenance: who/what/where produced a result artifact.

Every ``BENCH_*.json`` and ``obs_summary.json`` should answer "which
commit, which torch and CUDA, which devices, when" without forensic work —
otherwise the bench trajectory across PRs compares apples to unknowns.
:func:`build_meta` collects the answer cheaply and degrades gracefully
(missing git, no devices yet) so it can run anywhere from CI to a
laptop without adding dependencies.

The wall date is deliberately **not** read from the system clock by
default: benches must stay reproducible byte-for-byte on re-runs.  CI
passes it explicitly (``--date`` flags / ``BENCH_DATE`` env var).
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

__all__ = ["build_meta", "git_sha"]

_REPO_ROOT = Path(__file__).resolve().parents[3]


def git_sha(root: Path | None = None) -> str | None:
    """The current commit SHA, or None outside a git checkout.

    CI environments expose it as an env var (``GITHUB_SHA``) even on
    shallow/detached checkouts, so that wins over asking git.
    """
    for var in ("GITHUB_SHA", "GIT_SHA", "CI_COMMIT_SHA"):
        sha = os.environ.get(var)
        if sha:
            return sha
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root or _REPO_ROOT,
            capture_output=True, text=True, timeout=10)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError):
        return None


def _device_topology() -> list[list] | None:
    """(platform, kind, count) summary of the visible CUDA devices, or the
    host's when there is none; None when the query fails."""
    try:
        import torch

        from ..runtime.store import device_topology
        return device_topology(None if torch.cuda.is_available() else "cpu")
    except Exception:       # noqa: BLE001 — provenance must never crash a run
        return None


def _driver() -> str | None:
    """The NVIDIA driver version ``nvidia-smi`` reports, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def build_meta(date: str | None = None, *, devices: bool = True) -> dict:
    """The ``meta`` block stamped into result artifacts.

    ``date`` is the CI-supplied wall date (falls back to the
    ``BENCH_DATE`` env var, then None — never the system clock, see
    module docstring).  ``devices=False`` skips the CUDA queries (the
    driver, the device's name) for callers that must not initialize
    CUDA.
    """
    import torch

    cuda = devices and torch.cuda.is_available()
    return {
        "git_sha": git_sha(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "driver": _driver() if cuda else None,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "devices": _device_topology() if devices else None,
        "date": date or os.environ.get("BENCH_DATE"),
    }
