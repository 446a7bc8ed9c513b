#!/usr/bin/env python3
"""Where ``fa_match`` spends its time on the card, across its launch space.

    python3 scripts/torch_dna_sweep.py [--t 3221225472] [--motifs ACGTAC,ACGTACGT]
        [--chunks 1024,...,65536] [--block-threads 128,256,512] [--gram 1,2,4]

For each motif and every point of the given map chunks x threads a block x
grams it times the state-map kernel (B1, ``dna_state_map``), for every map
chunk the plain-PyTorch ``compose_maps`` between the passes, and for every
count chunk x threads x grams the count kernel (B2, ``dna_count_hits``),
each the device mean of back-to-back calls (``chip_smoke.device_ms``'s
timing); each line carries the kernel's route and the three reckonings of
its design (``kernel.reckonings``: bytes, shared-memory wavefronts,
integer instructions).  Then, over the valid points of the tuning space
(count chunk a multiple of the map chunk), the best sum B1 + compose + B2,
and ``fa_match`` timed whole at that point and at the defaults.  The first
line is the card's name and power limit as ``nvidia-smi`` prints them.
Needs one CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def main() -> int:
    from repro_torch.tune.kernels.specs import (BLOCK_THREADS, GRAMS,
                                                TEXT_CHUNKS)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=3 * 2 ** 30)
    ap.add_argument("--motifs", default="ACGTAC")
    ap.add_argument("--chunks", type=ints, default=list(TEXT_CHUNKS))
    ap.add_argument("--block-threads", type=ints, default=list(BLOCK_THREADS))
    ap.add_argument("--gram", type=ints, default=list(GRAMS))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_dna_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.convert import dfa_to_device
    from repro_torch.kernels.dna_automaton import kernel, ops
    from repro_torch.tune.kernels.evaluate import (device_seconds,
                                                   probe_seconds)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def ms(fn, repeats=5):
        host_s, _ = probe_seconds(fn, torch.device("cuda"))
        return device_seconds(fn, repeats, host_s) * 1e3

    text = ops.random_dna_text(args.t, seed=0, device="cuda")
    t = text.shape[0]
    points = [(bt, g) for bt in args.block_threads for g in args.gram]
    for motif in args.motifs.split(","):
        table, accept = dfa_to_device(*ops.build_motif_dfa(motif), "cuda")
        s = table.shape[0]
        route = kernel.route_of(s)
        b1, b2, compose = {}, {}, {}
        for c in args.chunks:
            maps = kernel.state_map(text, table, chunk=c)
            compose[c] = ms(lambda: ops.compose_maps(maps), 3)
            starts = torch.cat([torch.zeros(1, dtype=torch.int32,
                                            device="cuda"),
                                ops.compose_maps(maps)[:-1, 0]])
            del maps
            for bt, g in points:
                b1[c, bt, g] = ms(lambda: kernel.state_map(
                    text, table, chunk=c, block_threads=bt, gram=g))
                b2[c, bt, g] = ms(lambda: kernel.count_hits(
                    text, table, accept, starts, chunk=c, block_threads=bt,
                    gram=g))
                print(json.dumps({
                    "motif": motif, "s": s, "t": t, "chunk": c,
                    "block_threads": bt, "gram": g, "route": route,
                    "state_map_ms": b1[c, bt, g],
                    "count_hits_ms": b2[c, bt, g],
                    "compose_maps_ms": compose[c],
                    "state_map_reckon": kernel.reckonings(
                        route, t, s, g, chunk=c, threads=bt),
                    "count_hits_reckon": kernel.reckonings(
                        "count", t, s, g, chunk=c, threads=bt)}), flush=True)
            del starts
            torch.cuda.empty_cache()
        best = min(((b1[mc, bt, g] + compose[mc] + b2[cc, bt, g]),
                    {"map_chunk": mc, "count_chunk": cc, "block_threads": bt,
                     "gram": g})
                   for mc in args.chunks for cc in args.chunks
                   if cc % mc == 0 for bt, g in points)
        fa_best = ms(lambda: ops.fa_match(text, table, accept, tuned=False,
                                          **best[1]), 3)
        fa_default = ms(lambda: ops.fa_match(text, table, accept,
                                             tuned=False), 3)
        print(json.dumps({"motif": motif, "s": s, "best": best[1],
                          "best_sum_ms": best[0], "fa_match_best_ms": fa_best,
                          "defaults": dict(ops.DEFAULTS),
                          "fa_match_default_ms": fa_default}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
