"""Roofline report: the port's dry-run file + the analytic ledger -> rows.

Per (arch x cell) on the single-pod mesh: compute/memory/collective terms
(seconds, reckoned for the H100: ``analysis.H100_SXM``), the dominant
term, MODEL_FLOPS, the MODEL_FLOPS / ledger-FLOPs ratio, the MFU bound,
the dry run's peak bytes a rank and counted FLOPs, and a one-line lever
note.  The collective term reads the dry run's census
(``roofline.census``).  Nothing here is measured on a card.

Usage:  python -m repro_torch.roofline.report [--json results/dryrun_torch.json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from .. import configs
from ..launch import policies, shapes
from . import analysis

__all__ = ["LEVERS", "build_rows", "to_markdown"]

LEVERS = {
    "compute_s": "already compute-bound: raise MFU through the kernels "
                 "and drop remat recompute",
    "memory_s": "cut HBM traffic: larger microbatches amortise weight "
                "reads; selective remat; bf16 activations end-to-end",
    "collective_s": "shrink wire bytes: wider data axis vs model axis, "
                    "int8 gradient all-reduce, overlap FSDP gathers with "
                    "compute",
}


def build_rows(dryrun_path: Path, mesh_name: str = "single",
               hw: analysis.HW = analysis.H100_SXM) -> list[dict]:
    records = json.loads(Path(dryrun_path).read_text())
    rows = []
    for rec in records:
        if rec.get("mesh") != mesh_name or not rec.get("ok"):
            continue
        cfg0 = configs.get(rec["arch"])
        cell = shapes.SHAPE_CELLS[rec["cell"]]
        cfg = policies.arch_for_cell(cfg0, cell)
        scfg = policies.default_sharding(cfg, cell)
        n_chips = rec["n_devices"]
        ledger = analysis.analytic_cost(cfg, cell, scfg, n_chips=n_chips)
        coll = rec["collectives"]["transfer_bytes_per_step"]
        terms = analysis.roofline_terms(ledger, coll, n_chips, hw)
        rows.append({
            "arch": rec["arch"], "cell": rec["cell"], "n_chips": n_chips,
            "peak_gb": rec["memory"]["peak_per_device_gb"],
            "fits": rec["memory"]["peak_per_device_gb"] * 2**30
            <= hw.hbm_gb * 1e9,
            "counted_flops": rec["flops"]["total"],
            **{k: terms[k] for k in
               ("compute_s", "memory_s", "collective_s", "dominant",
                "step_time_bound_s", "roofline_fraction", "model_flops",
                "hlo_flops", "useful_flops_ratio", "mfu_bound")},
            "lever": LEVERS[terms["dominant"]],
        })
    return rows


def to_markdown(rows: list[dict]) -> str:
    hdr = ("| arch | cell | compute s | memory s | collective s | dominant "
           "| bound s | MFU bound | useful-FLOP ratio | peak GiB/rank |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['cell']} | {r['compute_s']:.4f} "
            f"| {r['memory_s']:.4f} | {r['collective_s']:.4f} "
            f"| {r['dominant'].replace('_s', '')} "
            f"| {r['step_time_bound_s']:.4f} | {r['mfu_bound'] * 100:.1f}% "
            f"| {r['useful_flops_ratio']:.2f} | {r['peak_gb']:.2f} |")
    return hdr + "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    root = Path(__file__).resolve().parents[3]
    ap.add_argument("--json", default=str(root / "results" /
                                          "dryrun_torch.json"))
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--out", default=str(root / "results" /
                                         "roofline_torch.json"))
    args = ap.parse_args(argv)
    rows = build_rows(Path(args.json), args.mesh)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    print(to_markdown(rows))
    print(f"\n{len(rows)} cells -> {args.out}")


if __name__ == "__main__":
    main()
