#!/usr/bin/env python3
"""How far the training path's gradients sit from their gates, over seeds,
and whether the gates catch a wrong attention backward.

    python3 scripts/torch_train_gate.py [--seeds 0 1 2] [--out DIR]

For each seed it runs ``chip_smoke.py``'s ``lm_train_parity`` phase:
Qwen2.5-3B at full width with random weights from the seed, one
loss-and-gradient pass through the attention kernels and one through
their plain versions, on the seed's first ``SyntheticPipeline`` batch
(2 x 2048 tokens).  It prints the worst relative L2 among the key biases
and among the other leaves beside ``chip_smoke.GRAD_GATE``.  On the
first seed it also runs three wrong backwards in place of the kernel
(the plain version with dk and dv swapped, with dq left without the
softmax scale, and with the causal mask one key too late) and reports
whether the gate catches each.  Writes ``train_gate.json`` into ``--out``
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
        model, report = smoke.phase_lm_train_parity(
            seed, wrong_backwards() if i == 0 else None)
        rows.append(report)
        del model
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / "train_gate.json").write_text(json.dumps(
        {"rows": rows, "gate": smoke.GRAD_GATE, "card": smi}, indent=1))
    print(json.dumps({"worst": {r["seed"]: r["grad_rel_l2_max"]
                                for r in rows},
                      "controls": rows[0].get("controls")}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
