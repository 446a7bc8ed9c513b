#!/usr/bin/env python3
"""How far the training paths' gradients sit from their gates, over seeds,
and whether the gates catch a wrong backward.

    python3 scripts/torch_train_gate.py [--arch ARCH] [--seeds 0 1 2] [--out DIR]

For ``--arch qwen2.5-3b`` (the default) it runs ``chip_smoke.py``'s
``lm_train_parity`` phase for each seed: Qwen2.5-3B at full width with
random weights from the seed, one loss-and-gradient pass through the
attention kernels and one through their plain versions, on the seed's
first ``SyntheticPipeline`` batch (2 x 2048 tokens).  It prints the worst
relative L2 among the key biases and among the other leaves beside
``chip_smoke.GRAD_GATE``.  On the first seed it also runs three wrong
backwards in place of the kernel (the plain version with dk and dv
swapped, with dq left without the softmax scale, and with the causal mask
one key too late) and reports whether the gate catches each.

For ``--arch rwkv6-1.6b`` or ``jamba-v0.1-52b`` it runs the
``rwkv_train_parity`` / ``jamba_train_parity`` phase for each seed (float32
compute, the kernels and the plain versions each held against a float64
pass, with the phase's wrong-backward control) and adds, for every
parameter, the kernels' and the plain path's largest distance from the
float64 gradient over its leaves beside its gate, and the leaves a gate of
1.5 x each leaf's own plain reading would refuse.

Writes ``train_gate.json`` (or ``train_gate_<arch>.json``) into ``--out``
(default ``results/``); the last line names the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def wrong_backwards() -> dict:
    import chip_smoke as smoke

    def swapped(*args, **kw):
        dq, dk, dv = smoke.plain_attention_bwd(*args, **kw)
        return dq, dv, dk

    def unscaled(q, *args, **kw):
        dq, dk, dv = smoke.plain_attention_bwd(q, *args, **kw)
        return dq * q.shape[-1] ** 0.5, dk, dv

    def late_mask(*args, q_offset, **kw):
        return smoke.plain_attention_bwd(*args, q_offset=q_offset + 1, **kw)

    return {"dk_dv_swapped": swapped, "dq_scale_missing": unscaled,
            "mask_one_key_late": late_mask}


def recurrent_row(smoke, arch: str, seed: int) -> dict:
    """One recurrent training-parity phase, its report with every
    parameter's readings beside its gate, or the gate's refusal."""
    try:
        model, report = smoke.phase_ssm_train_parity(arch, seed)
    except AssertionError as e:
        return {"seed": seed, "refused": str(e)}
    del model
    leaves = report.pop("leaves")
    k, p = leaves["kernels_vs_float64"], leaves["plain_vs_float64"]
    gates = smoke.leaf_gates(p)
    params: dict = {}
    for n in k:
        row = params.setdefault(smoke.leaf_kind(n), {
            "leaves": 0, "kernels_max": 0.0, "plain_max": 0.0,
            "gate": gates[smoke.leaf_kind(n)]})
        row["leaves"] += 1
        row["kernels_max"] = max(row["kernels_max"], k[n])
        row["plain_max"] = max(row["plain_max"], p[n])
    own = {n: [k[n], max(smoke.SSM_GRAD_GATE, smoke.GRAD_FLOOR_MARGIN * p[n])]
           for n in k
           if k[n] > max(smoke.SSM_GRAD_GATE, smoke.GRAD_FLOOR_MARGIN * p[n])}
    report.update(
        params=params, leaves=leaves,
        plain_over_grad_gate=sum(v > smoke.SSM_GRAD_GATE for v in p.values()),
        n_leaves=len(p), own_leaf_gate_refuses=len(own),
        own_leaf_gate_worst=sorted(own.items(), key=lambda kv: -kv[1][0])[:5])
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b",
                    choices=["qwen2.5-3b", "rwkv6-1.6b", "jamba-v0.1-52b"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--out", type=Path, default=ROOT / "results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    smoke.phase_build()
    rows = []
    for i, seed in enumerate(args.seeds):
        if args.arch == smoke.LM_ARCH:
            model, report = smoke.phase_lm_train_parity(
                seed, wrong_backwards() if i == 0 else None)
            del model
        else:
            report = recurrent_row(smoke, args.arch, seed)
        rows.append(report)
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    args.out.mkdir(parents=True, exist_ok=True)
    if args.arch == smoke.LM_ARCH:
        (args.out / "train_gate.json").write_text(json.dumps(
            {"rows": rows, "gate": smoke.GRAD_GATE, "card": smi}, indent=1))
        print(json.dumps({"worst": {r["seed"]: r["grad_rel_l2_max"]
                                    for r in rows},
                          "controls": rows[0].get("controls")}), flush=True)
    else:
        (args.out / f"train_gate_{args.arch}.json").write_text(json.dumps(
            {"rows": rows, "card": smi}, indent=1))
        for r in rows:
            print(json.dumps({k: v for k, v in r.items()
                              if k not in ("leaves", "params")}), flush=True)
    print(smi)
    return 0

if __name__ == "__main__":
    sys.exit(main())
