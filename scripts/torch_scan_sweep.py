#!/usr/bin/env python3
"""How close a 5 % tune of the scan kernels comes to the whole space.

    python3 scripts/torch_scan_sweep.py [--out DIR]

At the shapes ``chip_smoke.py`` serves and trains (the wkv forward at
RWKV-6 1.6B's prefill, B 8, T 2048, H 32, hd 64; the selective scan at
Jamba's prefill, B 8, T 2048, dI 8192, S 16, and at its training batch,
B 2; the wkv backward at RWKV-6's training shape, the same B 8 x 2048;
the selective-scan backward at Jamba's, B 2 x 2048; float32),
``tune_kernel`` tunes each kernel as the ``ssm_tune`` / ``ssm_bwd_tune``
phases do, and then the same ``KernelTimer`` (parity-gated against the
plain version, timed in batches of back-to-back calls) measures every
other configuration of the spec's space.  Prints, per kernel and shape,
the tune's measurements, its winner, the default and the exhaustive best,
the winner's rank, and the best time of each chunk length (the selective
scan: of each split, chunk and block's thread count), with
the programs of the kernels that have several timed apart at the default
and at the best point (``chip_smoke.device_ms``): the wkv forward's
``states`` and ``chunks`` (and its serial route at T = 1, a decode step),
the wkv backward's ``scans`` and ``chunks``, the selective-scan backward's
``summaries``, ``carry`` and ``chunks``.  Writes every configuration's
time to ``scan_sweep.json`` in ``--out`` (default ``results/``).  The last
line names the card.
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


def best_by(valid, key) -> dict:
    """The best time (ms) of each group of configurations."""
    out: dict = {}
    for s, cfg in valid:
        group = str(key(cfg))
        out[group] = min(out.get(group, math.inf), s * 1e3)
    return out


def inputs(n: int, shape_of) -> list:
    """``n`` uniform tensors on the card, the i-th of shape ``shape_of(i)``,
    from seed 0."""
    gen = torch.Generator("cuda")
    gen.manual_seed(0)
    return [torch.rand(shape_of(i), generator=gen, device="cuda")
            for i in range(n)]


def wkv_bwd_programs(meta: dict, launch: dict) -> dict:
    """The wkv backward's two programs timed apart (ms) at ``launch``."""
    import chip_smoke as smoke
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk

    b, t, h, hd = (meta[k] for k in ("b", "t", "h", "hd"))
    r, k, v, w, dy, u, s0, ds = inputs(8, lambda i: (
        (b, t, h, hd) if i < 5 else (h, hd) if i == 5 else (b, h, hd, hd)))
    n = -(-t // launch["chunk"])
    states = torch.empty((b, h, n, hd, hd), device="cuda")
    adj = torch.empty_like(states)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((b, h, n, hd), device="cuda")
    ds0 = torch.empty_like(s0)
    lib = wkk._library_bwd()
    tail = (b, t, h, hd, launch["chunk"], launch["block_threads"],
            launch["cols"], launch["parts"])
    stream = torch.cuda.current_stream().cuda_stream

    def scans():
        lib.rwkv6_wkv_bwd_scans(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                w.data_ptr(), dy.data_ptr(), s0.data_ptr(),
                                ds.data_ptr(), states.data_ptr(),
                                adj.data_ptr(), ds0.data_ptr(), *tail, stream)

    def chunks():
        lib.rwkv6_wkv_bwd_chunks(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 w.data_ptr(), u.data_ptr(), dy.data_ptr(),
                                 states.data_ptr(), adj.data_ptr(),
                                 dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 dw.data_ptr(), du.data_ptr(), *tail, stream)

    scans()
    chunks()
    return {"scans_ms": smoke.device_ms(scans, 10),
            "chunks_ms": smoke.device_ms(chunks, 10)}


def wkv_fwd_programs(meta: dict, launch: dict) -> dict:
    """The wkv forward's chunked route, its two programs timed apart (ms)
    at ``launch``."""
    import chip_smoke as smoke

    b, t, h, hd = (meta[k] for k in ("b", "t", "h", "hd"))
    r, k, v, w, u, s0 = inputs(6, lambda i: (
        (b, t, h, hd) if i < 4 else (h, hd) if i == 4 else (b, h, hd, hd)))
    return smoke.wkv_fwd_programs_ms(r, k, v, w, u, s0, launch)


def wkv_decode_ms(meta: dict) -> float:
    """The wkv forward at T = 1 (a decode step: its serial route) (ms)."""
    import chip_smoke as smoke
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk
    from repro_torch.kernels.rwkv6_wkv.ops import DEFAULTS

    b, h, hd = (meta[k] for k in ("b", "h", "hd"))
    r, k, v, w, u, s0 = inputs(6, lambda i: (
        (b, 1, h, hd) if i < 4 else (h, hd) if i == 4 else (b, h, hd, hd)))
    return smoke.device_ms(lambda: wkk.wkv6_fwd(r, k, v, w, u, s0,
                                                **DEFAULTS), 50)


def scan_bwd_programs(meta: dict, launch: dict) -> dict:
    """The selective-scan backward's three programs timed apart (ms) at
    ``launch``."""
    import chip_smoke as smoke

    bt, t, di, s = (meta[k] for k in ("bt", "t", "di", "s"))
    shapes = [(bt, t, di), (bt, t, di), (di, s), (bt, t, s), (bt, t, s),
              (di,), (bt, di, s), (bt, t, di), (bt, di, s)]
    x, dl, a, bm, cm, d, h0, dy, dh = inputs(9, lambda i: shapes[i])
    return smoke.scan_bwd_programs_ms(x, dl * 0.1, -(a + 0.5), bm, cm, d,
                                      h0, dy, dh, launch)


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
    metas = [*smoke.ssm_metas().items(), *smoke.ssm_train_metas().items()]
    for name, meta in metas:
        out = ktune.tune_kernel(name, meta, seed=0)
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
            "n_parity_rejected": sum("parity" in r for r in
                                     out.timer.rejected.values()),
            "default_config": out.default_config,
            "default_ms": out.default_time() * 1e3,
            "winner_config": out.best_config, "winner_ms": winner_s * 1e3,
            "best_config": valid[0][1], "best_ms": valid[0][0] * 1e3,
            "winner_over_best": winner_s / valid[0][0],
            "winner_rank": 1 + sum(s < winner_s for s, _ in valid),
            "all_ms": [[cfg, s * 1e3] for s, cfg in valid]})
        if name == "mamba_scan":
            report[-1].update({
                key: best_by(valid, fn) for key, fn in (
                    ("best_ms_by_split", lambda c: c["split"]),
                    ("best_ms_by_chunk", lambda c: c["chunk"]),
                    ("best_ms_by_threads",
                     lambda c: c["block_d"] * c["split"]))})
        else:
            programs = {"rwkv6_wkv": wkv_fwd_programs,
                        "rwkv6_wkv_bwd": wkv_bwd_programs,
                        "mamba_scan_bwd": scan_bwd_programs}[name]
            report[-1].update({
                "best_ms_by_chunk": best_by(valid, lambda c: c["chunk"]),
                "default_programs": programs(meta, out.default_config),
                "best_programs": programs(meta, valid[0][1])})
        if name in ("mamba_scan_bwd", "rwkv6_wkv"):
            report[-1]["best_ms_by_split"] = best_by(valid,
                                                     lambda c: c["split"])
        if name == "rwkv6_wkv":
            report[-1]["decode_t1_ms"] = wkv_decode_ms(meta)
        print(json.dumps({k: v for k, v in report[-1].items()
                          if k != "all_ms"}), flush=True)
        del out
        torch.cuda.empty_cache()
    args.out.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    (args.out / "scan_sweep.json").write_text(json.dumps(
        {"kernels": report, "card": smi}, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
