"""Asynchronous, atomic checkpointing of a training state.

Layout (one directory per step), the reference's:

    <root>/step_000000120.tmp/   — written first
        manifest.json            — leaf names, shapes, dtypes, step,
                                   ``extra``, wall-clock
        arr_000000.npy ...       — one file per leaf
    <root>/step_000000120/       — os.replace of the .tmp directory

A state is a nested ``dict`` whose leaves are tensors (or anything
``torch.as_tensor`` takes).  Leaves are named by their key path joined
with ``/`` (``"opt/m/layers.0.mixer.wq"``), where the reference records a
JAX treedef; so the two packages cannot read each other's checkpoints.
bfloat16 has no numpy type and is stored as a uint16 view; the manifest's
dtype restores it.

Async: ``save`` copies the leaves to host memory at once (so the caller
may go on updating its tensors in place) and writes the files on a worker
thread; the next ``save`` or ``wait()`` joins it.  Atomicity means a crash
mid-save never corrupts the latest complete checkpoint: a ``.tmp``
directory is never read.  ``keep`` bounds how many complete checkpoints
stay on disk.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["CheckpointManager"]

SEP = "/"


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        key = str(key)
        if SEP in key:
            raise ValueError(f"checkpoint key {key!r} holds {SEP!r}")
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + SEP))
        else:
            out[path] = value
    return out


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        *parents, leaf = path.split(SEP)
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _to_numpy(x: Any) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its dtype's name."""
    t = torch.as_tensor(x).detach()
    dtype = str(t.dtype).removeprefix("torch.")
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dtype
    return t.numpy(), dtype


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
        if str(t.dtype).removeprefix("torch.") != dtype:
            raise ValueError(f"leaf stored as {arr.dtype}, manifest says "
                             f"{dtype}")
    return t.to(device) if device is not None else t


class CheckpointManager:
    def __init__(self, root: str | Path, keep: int = 3,
                 async_save: bool = True):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ------------------------------------------------------------------
    def save(self, step: int, state: Mapping[str, Any],
             extra: dict | None = None) -> None:
        self.wait()
        flat = _flatten(state)
        names = list(flat)
        leaves = [_to_numpy(flat[n]) for n in names]   # device -> host now
        manifest = {
            "step": int(step),
            "names": names,
            "n_leaves": len(names),
            "shapes": [list(a.shape) for a, _ in leaves],
            "dtypes": [dt for _, dt in leaves],
            "extra": extra or {},
            "time": time.time(),
        }

        def write():
            tmp = self.root / f"step_{step:09d}.tmp"
            final = self.root / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, (arr, _) in enumerate(leaves):
                np.save(tmp / f"arr_{i:06d}.npy", arr)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()

        if self.async_save:
            def run():
                try:
                    write()
                except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                    self._error = e

            self._worker = threading.Thread(target=run, daemon=True)
            self._worker.start()
        else:
            write()

    def wait(self) -> None:
        """Join the writer of the last ``save``; re-raise what it raised."""
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.root / f"step_{s:09d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.root.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and not p.name.endswith(".tmp") \
                    and (p / "manifest.json").exists():
                out.append(int(p.name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None,
                device=None) -> tuple[int, dict, dict]:
        """Returns (step, state, extra): the nested dict as it was saved,
        its leaves tensors on ``device`` (``None``: the CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:09d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat = {}
        for i, (name, dtype) in enumerate(zip(manifest["names"],
                                              manifest["dtypes"])):
            arr = np.load(d / f"arr_{i:06d}.npy")
            flat[name] = _from_numpy(arr, dtype, device)
        return manifest["step"], _unflatten(flat), manifest.get("extra", {})
