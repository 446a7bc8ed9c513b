"""Perf-iteration driver: evaluate one (arch x cell) under config overrides.

Each invocation is one hypothesis -> measure cycle: the cell's dry run on
rank 0's view of the mesh (``launch.dryrun``: meta tensors, a fake
process group, the collective census of the step's counters), the
analytic ledger -> roofline terms for the H100 (``roofline.analysis``),
and a per-kind collective breakdown so the dominant term can be
attributed.  No card is needed; nothing here is a measured time.

    PYTHONPATH=src python -m repro_torch.launch.perf --arch jamba-v0.1-52b \\
        --shape train_4k [--set microbatches=4 remat=False ...] \\
        [--mesh-shape 64x4]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

from .. import configs
from ..roofline import analysis
from . import policies, shapes
from .dryrun import build_bundle, fake_ranks, measure

__all__ = ["evaluate", "parse_override"]


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    if v in ("True", "False"):
        v = v == "True"
    elif v.isdigit():
        v = int(v)
    elif "," in v:
        v = tuple(x for x in v.split(",") if x)
    return k, v


def evaluate(arch: str, shape: str, scfg_overrides: dict,
             arch_overrides: dict, mesh_shape=(16, 16),
             mesh_axes=("data", "model"),
             hw: analysis.HW = analysis.H100_SXM) -> dict:
    cell = shapes.SHAPE_CELLS[shape]
    cfg = policies.arch_for_cell(configs.get(arch), cell)
    if arch_overrides:
        cfg = dataclasses.replace(cfg, **arch_overrides)
    scfg = policies.default_sharding(cfg, cell)
    if scfg_overrides:
        scfg = dataclasses.replace(scfg, **scfg_overrides)
    n_chips = math.prod(mesh_shape)
    t0 = time.time()
    with fake_ranks(tuple(mesh_shape), tuple(mesh_axes)) as mesh:
        rec = measure(build_bundle(arch, cell, mesh, scfg, cfg=cfg), mesh)
    census = rec["collectives"]
    ledger = analysis.analytic_cost(cfg, cell, scfg, n_chips=n_chips)
    terms = analysis.roofline_terms(
        ledger, census["transfer_bytes_per_step"], n_chips, hw)
    return {
        "arch": arch, "cell": shape, "mesh": "x".join(map(str, mesh_shape)),
        "overrides": {**scfg_overrides, **arch_overrides},
        "dryrun_s": round(time.time() - t0, 1),
        "peak_gb": round(rec["memory"]["peak_per_device_gb"], 2),
        "counted_flops": rec["flops"]["total"],
        **{k: (round(v, 5) if isinstance(v, float) else v)
           for k, v in terms.items()},
        "collective_breakdown_gb": {
            k: round(v["transfer_bytes"] / 2**30, 3)
            for k, v in census["weighted"].items()
            if v["transfer_bytes"]},
        "ledger_detail_top": dict(sorted(
            ((k, f"{v['flops']:.3g}F/{v['hbm']/2**30:.2f}GiB")
             for k, v in ledger.detail.items()),
            key=lambda kv: kv[0])),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", required=True, choices=list(shapes.SHAPE_CELLS))
    ap.add_argument("--set", nargs="*", default=[],
                    help="ShardingConfig overrides k=v")
    ap.add_argument("--arch-set", nargs="*", default=[],
                    help="ArchConfig overrides k=v")
    ap.add_argument("--mesh-shape", default="16x16")
    args = ap.parse_args(argv)
    scfg_over = dict(parse_override(kv) for kv in args.set)
    arch_over = dict(parse_override(kv) for kv in args.arch_set)
    mesh_shape = tuple(int(x) for x in args.mesh_shape.split("x"))
    axes = ("data", "model") if len(mesh_shape) == 2 \
        else ("pod", "data", "model")
    rec = evaluate(args.arch, args.shape, scfg_over, arch_over,
                   mesh_shape, axes)
    print(json.dumps(rec, indent=1, default=str))


if __name__ == "__main__":
    main()
