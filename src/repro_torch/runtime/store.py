"""Persistent tuning cache keyed by workload signature.

Tuned configurations are expensive — the paper's SAML still costs
hundreds of measurements per workload.  ``TuningStore`` persists
``TuneResult``s to a JSON file keyed by a **workload signature**: a hash
of the config space (names, values, ordinality), a caller-supplied
workload payload (shapes, dtype, anything that changes measured times)
and the device topology.  A repeated workload is served from the cache
with zero new measurements; any change to space, workload or topology
changes the signature and forces a fresh search.

The device topology is ``[["gpu", <device name>, <count>]]`` when the
store is used on the card and ``[["cpu", "", 1]]`` on the CPU, so a
record tuned on one never serves the other.

``repro_torch.tune.TuningSession(store=...)`` consumes this (entries are
keyed per strategy *and* objective).  The file format — a checksummed
``{"checksum", "entries"}`` envelope — is the reference package's, so a
store written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import zipfile
from dataclasses import asdict
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .. import resolve_device
from ..core.space import ConfigSpace
from ..tune.result import TuneResult

__all__ = ["TuningStore", "device_topology", "quarantine",
           "space_fingerprint", "workload_signature"]

_log = logging.getLogger("repro_torch.runtime.store")


def quarantine(path: str | os.PathLike, reason: str = "corrupt") -> Path:
    """Move a corrupt durable file aside to ``<name>.corrupt-<sha8>``.

    The suffix is a hash of the file's raw bytes, so repeated
    quarantines of distinct corruptions never collide and identical
    corruptions are idempotent.  The original path is free afterwards
    (the caller starts fresh).  Returns the quarantine path.
    """
    p = Path(path)
    sha8 = hashlib.sha256(p.read_bytes()).hexdigest()[:8]
    dest = p.with_name(p.name + f".corrupt-{sha8}")
    os.replace(p, dest)
    _log.warning("quarantined corrupt file %s -> %s (%s)", p, dest.name,
                 reason)
    return dest


def _canon(obj: Any):
    """Canonicalize a workload payload for hashing.

    Semantically identical payloads must hash identically regardless of
    how the caller spelled them: dict keys are stringified and sorted
    (insertion order never matters), tuples and lists normalize to one
    shape, sets/frozensets are ordered, numpy scalars/arrays become
    plain Python.  Anything else falls back to ``repr``.
    """
    if isinstance(obj, Mapping):
        return {str(k): _canon(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted((_canon(v) for v in obj), key=repr)
    if isinstance(obj, np.ndarray):
        return [_canon(v) for v in obj.tolist()]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def _sha(payload: Any) -> str:
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def space_fingerprint(space: ConfigSpace) -> str:
    """Hash of the space structure: parameter names, domains, ordinality."""
    return _sha([[p.name, _canon(p.values), bool(p.ordinal)]
                 for p in space.params])[:16]


def device_topology(device=None) -> list[list]:
    """Summary of the devices a store is used on: (platform, kind, count).

    On the card (``device=None`` or a CUDA device): the visible CUDA
    devices by name.  On ``device="cpu"``: ``[["cpu", "", 1]]``.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [[dev.type, "", 1]]
    counts: dict[str, int] = {}
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        counts[name] = counts.get(name, 0) + 1
    return [["gpu", k, n] for k, n in sorted(counts.items())]


def workload_signature(space: ConfigSpace,
                       workload: Mapping[str, Any] | None = None,
                       devices: Any = None, device: Any = None) -> str:
    """Cache key: space hash + workload payload + device topology.

    ``devices`` defaults to the live :func:`device_topology` of
    ``device``; pass an explicit value (any canonicalizable object) to
    pin the signature in tests or across hosts.
    """
    return _sha({
        "space": space_fingerprint(space),
        "workload": _canon(workload),
        "devices": _canon(devices if devices is not None
                          else device_topology(device)),
    })


def _report_to_json(report: TuneResult) -> dict:
    d = asdict(report)
    d["checkpoints"] = {str(k): [e, cfg]
                        for k, (e, cfg) in report.checkpoints.items()}
    return d


def _report_from_json(d: Mapping[str, Any]) -> TuneResult:
    kw = dict(d)
    kw["checkpoints"] = {int(k): (float(e), dict(cfg))
                         for k, (e, cfg) in d.get("checkpoints", {}).items()}
    kw["from_cache"] = True
    return TuneResult(**kw)


class TuningStore:
    """JSON-backed map: workload signature -> recorded ``TuneResult``s.

    One store file holds many workloads; each entry keeps one report per
    strategy.  ``lookup``/``record`` are what ``TuningSession.run``
    calls; ``save_observations``/``load_observations`` persist
    feedback-loop arrays as an NPZ side-car per signature.

    ``device`` is the device the store is used on (``None`` = the card);
    its topology is part of every key unless ``devices`` pins one.
    """

    def __init__(self, path: str | os.PathLike, *, devices: Any = None,
                 device: Any = None):
        self.path = Path(path)
        self.devices = devices          # pin topology, or None for live
        self.device = device
        self._data: dict[str, dict] = {}
        if self.path.exists():
            self._data = self._load_or_quarantine()

    def _load_or_quarantine(self) -> dict:
        """Load the JSON store, surviving corruption.

        A truncated/unparsable file, a non-object payload, or a
        checksummed file whose digest mismatches is moved aside to
        ``<name>.corrupt-<sha8>`` (:func:`quarantine`) with a logged
        warning, and the store starts fresh — a
        corrupt cache must never take the tuner down with it.  Both
        layouts load: the legacy flat ``{sig: entry}`` and the
        checksummed ``{"checksum", "entries"}`` that :meth:`_flush`
        writes.
        """
        try:
            data = json.loads(self.path.read_text())
            if not isinstance(data, dict):
                raise ValueError("store payload is not an object")
            if "entries" in data and "checksum" in data:
                entries = data["entries"]
                if not isinstance(entries, dict):
                    raise ValueError("store entries is not an object")
                if data["checksum"] != _sha(entries):
                    raise ValueError("store checksum mismatch")
                return entries
            return data                         # legacy flat layout
        except (ValueError, UnicodeDecodeError) as exc:
            quarantine(self.path, reason=f"tuning store: {exc}")
            return {}

    # -- keys --------------------------------------------------------------
    def signature(self, space: ConfigSpace,
                  workload: Mapping[str, Any] | None) -> str:
        return workload_signature(space, workload, devices=self.devices,
                                  device=self.device)

    # -- report cache -------------------------------------------------------
    def lookup(self, space: ConfigSpace,
               workload: Mapping[str, Any] | None,
               strategy: str) -> TuneResult | None:
        entry = self._data.get(self.signature(space, workload))
        if entry is None or strategy.upper() not in entry.get("reports", {}):
            return None
        return _report_from_json(entry["reports"][strategy.upper()])

    def best_record(self, space: ConfigSpace,
                    workload: Mapping[str, Any] | None) -> TuneResult | None:
        """Best recorded report for a workload across *all* strategies.

        This is the resolution path of the kernel ``tuned=`` fast path
        (``repro_torch.tune.kernels.resolve_config``): whichever strategy
        produced the lowest measured score wins, no matter which one the
        caller tuned with.  Returns ``None`` when the workload has no
        entry (callers fall back to their defaults).
        """
        entry = self._data.get(self.signature(space, workload))
        if entry is None or not entry.get("reports"):
            return None
        best = min(entry["reports"].values(),
                   key=lambda d: float(d.get("best_energy_measured",
                                             float("inf"))))
        return _report_from_json(best)

    def record(self, space: ConfigSpace,
               workload: Mapping[str, Any] | None,
               strategy: str, report: TuneResult) -> str:
        sig = self.signature(space, workload)
        entry = self._data.setdefault(sig, {
            "space": space_fingerprint(space),
            "workload": _canon(workload),
            "reports": {},
        })
        entry["reports"][strategy.upper()] = _report_to_json(report)
        self._flush()
        return sig

    def __len__(self) -> int:
        return len(self._data)

    def _flush(self) -> None:
        # Checksummed envelope: the loader verifies the digest against the
        # entries so a torn write surfaces as quarantine, not silent
        # corruption.  Written atomically (tmp + rename).
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(self.path.suffix + ".tmp")
        payload = {"checksum": _sha(self._data), "entries": self._data}
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True))
        os.replace(tmp, self.path)

    # -- observation side-car (NPZ) ----------------------------------------
    def _npz_path(self, sig: str) -> Path:
        return self.path.parent / f"{self.path.stem}-{sig[:16]}.npz"

    def save_observations(self, sig: str, **arrays: np.ndarray) -> Path:
        """Persist feedback-loop arrays (e.g. host_X/host_y/dev_X/dev_y)."""
        out = self._npz_path(sig)
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out, **{k: np.asarray(v) for k, v in arrays.items()})
        return out

    def load_observations(self, sig: str) -> dict[str, np.ndarray] | None:
        p = self._npz_path(sig)
        if not p.exists():
            return None
        try:
            with np.load(p) as z:
                return {k: z[k] for k in z.files}
        except (ValueError, OSError, zipfile.BadZipFile) as exc:
            # A torn NPZ side-car must not take the feedback loop down:
            # quarantine it and report "no observations" (cold start).
            quarantine(p, reason=f"observation side-car: {exc}")
            return None
