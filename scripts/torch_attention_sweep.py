#!/usr/bin/env python3
"""How close a 5 % tune of the attention kernels comes to the whole space.

    python3 scripts/torch_attention_sweep.py [--out DIR]

At the shapes ``chip_smoke.py`` serves (prefill: B*H = 128, T = 2048,
hd = 128, causal; decode: B 8, KV 2, rep 8, hd 128, S = 2176; bfloat16),
``tune_kernel`` tunes each kernel as the ``lm_tune`` phase does, and then
the same ``KernelTimer`` (parity-gated against the plain version, timed in
batches of back-to-back calls) measures every other configuration of the
spec's space.  Prints, per kernel, the tune's measurements, its winner,
the default and the exhaustive best, and the winner's rank; writes every
configuration's time to ``attention_sweep.json`` in ``--out`` (default
``results/``).  The decode kernel (one launch a call, its split combine
inside) is swept over its whole space; its default and best points are
timed once more as ``chip_smoke.py`` times them (``device_ms``), beside
one ``scaled_dot_product_attention`` call on the same inputs (GQA, the
length mask).

The flash-attention backward has no tuning space (the reference has none):
at the training shape (B*H = 32, T = 2048, hd 128, causal, bfloat16) its
bfloat16 build is timed at each square block it takes (block_q = block_k =
block_threads / 2 in 16, 32, 64, 128; ``chip_smoke.device_ms``), beside
``BWD_DEFAULTS``, and each point is held against the plain version
(2e-2 of the largest |grad|).  The last line names the card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def backward_points(smoke) -> dict:
    """B5's bfloat16 build at the training shape, at each block it takes."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention.ops import BWD_DEFAULTS

    cfg = configs.get(smoke.LM_ARCH)
    b, t, h, hd = smoke.TRAIN_BATCH, smoke.TRAIN_SEQ, cfg.n_heads, cfg.head_dim
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    q, k, v, do = (torch.randn((b, t, h, hd), generator=gen, device="cuda")
                   .bfloat16() for _ in range(4))
    o, lse = fak.flash_attention_fwd(q, k, v, causal=True)
    want = fak.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    points = []
    for blk in (16, 32, 64, 128):
        launch = {"block_q": blk, "block_k": blk, "block_threads": 2 * blk}
        run = lambda: fak.flash_attention_bwd(  # noqa: E731
            q, k, v, o, lse, do, causal=True, **launch)
        err = max(smoke.grad_err(g, w) for g, w in zip(run(), want))
        points.append({"launch": launch, "ms": smoke.device_ms(run, 10),
                       "rel_err": err, "default": launch == BWD_DEFAULTS})
    best = min(points, key=lambda p: p["ms"])
    return {"kernel": "flash_attention_bwd", "shape": [b, t, h, hd],
            "default_config": dict(BWD_DEFAULTS),
            "best_config": best["launch"], "best_ms": best["ms"],
            "points": points}


def decode_points(smoke, meta: dict, points: dict) -> dict:
    """B4 at ``points`` (name -> launch) and SDPA, timed by ``device_ms``
    at the decode shape, full cache."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dak

    b, kv, rep, hd, s = (meta[k] for k in ("b", "kv", "rep", "hd", "s"))
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    q = torch.randn((b, kv, rep, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, s, kv, hd), generator=gen, device="cuda")
            .bfloat16() for _ in range(2))
    out = {name: smoke.device_ms(lambda: dak.decode_attention(  # noqa: B023
        q, k, v, s, **launch), 50) for name, launch in points.items()}
    qh, kh, vh = q.reshape(b, kv * rep, 1, hd), k.transpose(1, 2), v.transpose(1, 2)
    mask = torch.ones((1, 1, 1, s), dtype=torch.bool, device="cuda")
    out["sdpa"] = smoke.device_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, enable_gqa=True), 50)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "results")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.tune import kernels as ktune

    report = []
    for name, meta in smoke.lm_metas().items():
        out = ktune.tune_kernel(name, meta, dtype="bfloat16", seed=0)
        n_tune = out.n_measured
        configs = out.timer.spec.space(out.shape).enumerate()
        times = sorted(((out.timer(cfg), cfg) for cfg in configs),
                       key=lambda item: item[0])
        valid = [(s, cfg) for s, cfg in times if math.isfinite(s)]
        winner_s = out.best_time()
        report.append({
            "kernel": name, "shape": meta, "space_size": out.space_size,
            "n_valid": len(valid), "tune_n_measured": n_tune,
            "n_launch_failed": out.timer.n_launch_failed,
            "default_config": out.default_config,
            "default_ms": out.default_time() * 1e3,
            "winner_config": out.best_config, "winner_ms": winner_s * 1e3,
            "best_config": valid[0][1], "best_ms": valid[0][0] * 1e3,
            "winner_over_best": winner_s / valid[0][0],
            "winner_rank": 1 + sum(s < winner_s for s, _ in valid),
            "all_ms": [[cfg, s * 1e3] for s, cfg in valid]})
        if name == "decode_attention":
            report[-1]["device_ms"] = decode_points(smoke, meta, {
                "default": out.default_config, "winner": out.best_config,
                "best": valid[0][1]})
        print(json.dumps({k: v for k, v in report[-1].items()
                          if k != "all_ms"}), flush=True)
    report.append(backward_points(smoke))
    print(json.dumps(report[-1]), flush=True)
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    (args.out / "attention_sweep.json").write_text(json.dumps(
        {"kernels": report, "card": smi}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
