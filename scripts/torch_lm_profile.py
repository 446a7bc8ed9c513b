#!/usr/bin/env python3
"""Where one prefill and one decode step of Qwen2.5-3B spend their time.

    python3 scripts/torch_lm_profile.py [--out DIR]

Profiles the path ``chip_smoke.py`` serves, at its shapes (batch 8, a
2048-token prompt, cache capacity 2176): it tunes the flash-attention and
decode-attention kernels into a store exactly as ``chip_smoke.py``'s
``lm_tune`` phase does, ``configure``s the store, builds the full-width
model on the card (random weights, bfloat16), and traces one prefill of
the batch and one decode step at the last position with ``torch.profiler``.
It sums the card's kernel time by kind (``chip_smoke.device_split``, the
classifier the training phase uses too): the port's attention kernels,
matrix products (cuBLAS), and everything else (norms, RoPE, residual adds,
cache writes, the casts), and counts the card's activities (kernels and
copies) in each step.  The LM head's share is timed apart by
``chip_smoke.device_ms`` on the same shapes.  Host time is the step's wall
time (a synchronize on each side) less the card's busy time; its share is
the card's idle share.

Writes ``lm_profile.json`` and the two Chrome traces into ``--out``
(default ``results/``), and prints the summary as JSON lines; the last
line names the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def profile(fn, label: str, out: Path) -> dict:
    import chip_smoke as smoke

    fn()                                        # warm
    out.mkdir(parents=True, exist_ok=True)
    row = smoke.device_split(fn, trace=out / f"lm_profile_{label}.json")
    # the same step again without the profiler: its wall time
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    return {"step": label, "wall_ms_profiled": row["wall_ms"],
            "wall_ms": plain_wall_ms, "device_busy_ms": row["device_busy_ms"],
            "by_kind_ms": row["split_ms"], "idle_share": row["idle_share"],
            "device_launches": row["device_launches"], "top": row["top"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import numpy as np

    import chip_smoke as smoke
    from repro_torch import configs
    from repro_torch.models import build_model
    from repro_torch.tune import kernels as ktune

    cfg = configs.get(smoke.LM_ARCH)
    b, t = smoke.LM_BATCH, smoke.LM_PROMPT
    s = t + smoke.LM_GEN
    with tempfile.TemporaryDirectory(prefix="lm_profile_") as tmp:
        store_path = Path(tmp) / "kernels.json"
        smoke.phase_lm_tune(0, store_path)
        ktune.configure(store_path)
        resolved = {name: ktune.resolve_config(name, meta, "bfloat16",
                                               device="cuda")
                    for name, meta in smoke.lm_metas().items()}
        model = build_model(cfg, seed=0).cast_for_serving()
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (b, t)), device="cuda")
        _, state = model.prefill(tokens, max_len=s)
        last = tokens[:, -1:]
        rows = [profile(lambda: model.prefill(tokens, max_len=s), "prefill",
                        args.out),
                profile(lambda: model.decode_step(state, last, s - 1),
                        "decode", args.out)]
        ktune.disable()
    h_pre = torch.randn((b, 1, cfg.d_model), device="cuda").bfloat16()
    rows[0]["lm_head_ms"] = smoke.device_ms(lambda: model._logits(h_pre), 20)
    rows[1]["lm_head_ms"] = rows[0]["lm_head_ms"]     # same (B, 1, D) shape
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    (args.out / "lm_profile.json").write_text(json.dumps(
        {"rows": rows, "card": smi, "batch": b, "prompt_len": t,
         "cache": s, "resolved": resolved}, indent=1))
    for row in rows:
        print(json.dumps({**row, "resolved": resolved}), flush=True)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
