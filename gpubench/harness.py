"""One run of one cell: find its pieces by name, set up, measure the
window, check the outputs against the plain reference, print the result.

Everything a cell is made of is a file found by a name in
``BENCHMARK.json``:

  configs/<config>.json        the model as it is run (``arch``: the
                               port's ``ArchConfig`` fields; ``reference``:
                               the family module under ``reference/``)
  traffic/<traffic>.json       the traffic mix's parameters; its ``kind``
                               names the generator, ``traffic/<kind>.py``
  workloads/<cell>.json        the cell's correctness limits and sample
  metrics/<metric>.py          a per-layer metric's reader

A traffic kind module gives ``setup(cell) -> state``, ``window(state,
seconds, probe) -> {"attempted", "failed", "metrics"}`` and ``check(state)
-> [Check]``, which runs after the window with the program's state freed.
A metric module gives ``read(view) -> float | None`` (``None``: nothing
to read, and the metric is left out of the line), and where it times a
kernel, ``ENTRY`` ("module:function" of the port) and ``count(*args,
**kwargs) -> (flops, bytes)`` of one call.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType

import torch

from . import imports
from . import devtrace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Refused(RuntimeError):
    """The run cannot be made here (no card, a forbidden import)."""


@dataclass
class Check:
    """One number compared, and its limit (passes when value <= limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Cell:
    name: str
    seed: int
    device: torch.device
    config: dict                # configs/<config>.json
    mix: dict                   # traffic/<traffic>.json
    workload: dict              # workloads/<cell>.json
    reference: ModuleType       # reference/<family>.py

    @property
    def arch(self) -> dict:
        return self.config["arch"]


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def port_arch(arch: dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.models.config import (ArchConfig, MambaConfig,
                                           MoEConfig, RwkvConfig)
    kw = dict(arch)
    for key, cls in (("rwkv", RwkvConfig), ("moe", MoEConfig),
                     ("mamba", MambaConfig)):
        if kw.get(key) is not None:
            kw[key] = cls(**kw[key])
    if "layer_kinds" in kw:
        kw["layer_kinds"] = tuple(kw["layer_kinds"])
    return ArchConfig(**kw)


def load_cell(bench: dict, name: str, seed: int, device,
              root: Path = HERE) -> tuple[Cell, ModuleType]:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = read_json(root / "configs" / f"{entry['config']}.json")
    mix = read_json(root / "traffic" / f"{entry['traffic']}.json")
    workload = read_json(root / "workloads" / f"{name}.json")
    family = config["reference"]
    reference = importlib.import_module(f"gpubench.reference.{family}") \
        if root == HERE else load_module(
            root / "reference" / f"{family}.py", f"gpubench.reference.{family}")
    kind = load_module(root / "traffic" / f"{mix['kind']}.py",
                       f"gpubench_traffic_{mix['kind']}")
    return Cell(name, int(seed), torch.device(device), config, mix,
                workload, reference), kind


def cell_metrics(bench: dict, name: str, section: str) -> list[dict]:
    """The metrics of ``section`` that cell ``name`` reports: those that
    list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or name in m["workloads"]]


# -- device record ----------------------------------------------------------------

def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=index,name,clocks.sm,clocks.mem,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not available ({type(e).__name__})"


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# -- tracing -------------------------------------------------------------------------

@dataclass
class View:
    """What a per-layer metric reads: the traced window's device
    activities, the units (steps or batches) it holds, each recorded
    kernel entry's calls, and host-clock totals of the units outside it."""
    trace: tr.Trace
    acts: list
    lo: int
    hi: int
    units: int
    calls: dict = field(default_factory=dict)     # entry -> [(flops, bytes)]
    host: dict = field(default_factory=dict)      # "seconds", "flops", "units"

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9


class Probe:
    """Traces units ``first .. first + count - 1`` of a window under
    ``torch.profiler`` inside one host range, recording the shapes each
    kernel metric's entry is called with there; the other units' host
    seconds and model FLOPs are summed.  Off (``count == 0``) it only
    sums."""

    def __init__(self, count: int, first: int, recorders: dict,
                 ranges=()):
        self.count, self.first = count, first
        self.recorders = recorders        # entry -> (module, attr, count_fn)
        self.ranges = ranges
        self.calls = {e: [] for e in recorders}
        self.launches = {}
        self.prof = None
        self.trace = None
        self.host = {"seconds": 0.0, "flops": 0.0, "units": 0}
        self._saved = {}

    def traced(self, i: int) -> bool:
        return self.count > 0 and self.first <= i < self.first + self.count

    def _install(self) -> None:
        for entry, (mod, attr, count) in self.recorders.items():
            fn = getattr(mod, attr)
            self._saved[entry] = (mod, attr, fn)
            self.launches[entry] = getattr(fn, "launches", None)

            def wrap(*a, _fn=fn, _e=entry, _c=count, **k):
                self.calls[_e].append(_c(*a, **k))
                return _fn(*a, **k)
            setattr(mod, attr, wrap)

    def _restore(self) -> None:
        for entry, (mod, attr, fn) in self._saved.items():
            setattr(mod, attr, fn)
            before = self.launches.get(entry)
            if before is not None:
                self.launches[entry] = getattr(fn, "launches") - before
        self._saved = {}

    def unit(self, i: int, flops: float = 0.0):
        return _Unit(self, i, flops)


class _Unit:
    def __init__(self, probe: Probe, i: int, flops: float):
        self.p, self.i, self.flops = probe, i, flops

    def __enter__(self):
        p = self.p
        if p.traced(self.i) and self.i == p.first:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            p._install()
            p.prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
            p.prof.__enter__()
            p.rf = record_function(tr.WINDOW_RANGE)
            p.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        p = self.p
        if not p.traced(self.i):
            p.host["seconds"] += time.perf_counter() - self.t0
            p.host["flops"] += self.flops
            p.host["units"] += 1
        elif self.i == p.first + p.count - 1 or exc[0] is not None:
            p.rf.__exit__(None, None, None)
            p.prof.__exit__(None, None, None)
            p._restore()
            p.trace = tr.read(p.prof, p.ranges)
            p.prof = None
        return False


# -- the run -----------------------------------------------------------------------

def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", bench: dict | None = None, root: Path = HERE,
             t_start: float | None = None) -> tuple[dict, list[Check]]:
    """Runs cell ``name`` once; returns (the result line, its checks)."""
    t_start = time.time() if t_start is None else t_start
    bench = read_json(ROOT / "BENCHMARK.json") if bench is None else bench
    entry = next(w for w in bench["workloads"] if w["name"] == name)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < entry["chips"]:
            raise Refused(f"{torch.cuda.device_count()} cards, the cell asks "
                          f"for {entry['chips']}")
        say("device:", torch.cuda.get_device_name(0), "count",
            torch.cuda.device_count(), "torch", torch.__version__,
            "cuda", torch.version.cuda)
    cell, kind = load_cell(bench, name, seed, device, root)
    per_layer = cell_metrics(bench, name, "per_layer") if trace else []
    readers = {m["name"]: load_module(root / "metrics" / f"{m['name']}.py",
                                      f"gpubench_metric_{m['name']}")
               for m in per_layer}
    recorders = {}
    for mod in readers.values():
        if hasattr(mod, "ENTRY"):
            modname, attr = mod.ENTRY.split(":")
            recorders[mod.ENTRY] = (importlib.import_module(modname), attr,
                                    mod.count)
    traced = int(cell.mix.get("traced_units", 1)) if trace else 0
    probe = Probe(traced, int(cell.mix.get("traced_first", 1)), recorders,
                  tuple(cell.mix.get("ranges", ())))

    state = kind.setup(cell)
    if device.type == "cuda":
        torch.cuda.synchronize()
        say("nvidia-smi before the window:", nvidia_smi())
    tuning = "repro_torch.tune.kernels" in sys.modules
    say("kernel tuning measurements in this run: 0 (the tuning stack is "
        f"{'loaded' if tuning else 'not loaded'}; every kernel at its "
        "defaults)")
    t_window = time.time()
    out = kind.window(state, seconds, probe)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        say("nvidia-smi after the window:", nvidia_smi())
    else:
        peak = 0
    checks = kind.check(state)
    del state

    metrics = {}
    line_device = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(0)
                            if device.type == "cuda" else "cpu"),
                   "count": entry["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks),
              "attempted": int(out["attempted"]),
              "failed": int(out["failed"])}
    if trace:
        view = _view(probe)
        if view is None:
            say("trace: no traced window was recorded")
        else:
            busy = tr.busy_ns(tr.clip(view.acts, view.lo, view.hi)) / 1e9
            line_device["busy_s"] = busy
            line_device["window_s"] = view.window_s
            _report_launches(probe, view, readers)
            for m in per_layer:
                value = readers[m["name"]].read(view)
                if value is None:
                    say(f"metric {m['name']}: nothing to read, left out")
                    continue
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            result["breakdown"] = tr.breakdown(view.trace, view.acts,
                                               view.lo, view.hi)
    else:
        e2e = {m["name"]: m for m in cell_metrics(bench, name, "end_to_end")}
        values = dict(out["metrics"])
        values["setup_s"] = t_window - t_start
        for metric, m in e2e.items():
            metrics[metric] = {"value": float(values[metric]),
                               "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = line_device
    found = imports.loaded()
    if found:
        raise Refused(f"loaded after the window: {', '.join(found)}")
    for c in checks:
        say(f"check {c.name} {c.value!r} limit {c.limit!r}"
            f"{'' if c.ok else '  FAILED'}")
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def _view(probe: Probe) -> View | None:
    if probe.trace is None:
        return None
    found = tr.in_window(probe.trace)
    if found is None:
        return None
    acts, lo, hi = found
    return View(probe.trace, acts, lo, hi, probe.count, probe.calls,
                probe.host)


def _report_launches(probe: Probe, view: View, readers: dict) -> None:
    """Each kernel metric's calls as recorded, as the port's launch
    counter saw them, and as the trace holds its kernels."""
    for mod in readers.values():
        if not hasattr(mod, "ENTRY"):
            continue
        calls = probe.calls[mod.ENTRY]
        seen = sum(1 for a in view.acts
                   if any(k in a.name for k in mod.KERNELS))
        counted = probe.launches.get(mod.ENTRY)
        say(f"launches {mod.ENTRY}: {len(calls)} calls recorded, its "
            f"counter {counted}, {seen} kernels of {mod.KERNELS} in the "
            "trace")
        if (counted is not None and counted != len(calls)) or \
                (calls and not seen):
            say(f"launches {mod.ENTRY}: launches the trace cannot "
                "attribute (the counter and the trace disagree)")


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    breaches = imports.scan()
    if breaches:
        say("import check failed:", "; ".join(breaches))
        return 4
    try:
        result, _ = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=t_start)
    except Refused as e:
        say("refused:", e)
        return 3
    print(json.dumps(result), flush=True)
    return 0
