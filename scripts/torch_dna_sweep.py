#!/usr/bin/env python3
"""Where ``fa_match`` spends its time on the card, across sizes and chunks.

    python3 scripts/torch_dna_sweep.py [--t 268435456,3221225472]
                                       [--chunks 256,2048,16384,131072]
                                       [--block-threads 64,256,1024]

For every (text length, chunk, threads per block) it times the two CUDA
kernels (``dna_state_map``, ``dna_count_hits``) and the plain-PyTorch
``compose_maps`` between them with CUDA events (mean of 5 launches after
a warm-up), and prints one JSON line each, with the share of the
byte bound (text read once at 3.35e12 B/s) the kernels reach.  The first
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

HBM_BYTES_PER_S = 3.35e12


def ints(text: str) -> list[int]:
    return [int(v) for v in text.split(",")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=ints, default=[2 ** 28, 2 ** 30, 3 * 2 ** 30])
    ap.add_argument("--chunks", type=ints, default=[256, 2048, 16384, 131072])
    ap.add_argument("--block-threads", type=ints, default=[256])
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_dna_sweep: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.convert import dfa_to_device
    from repro_torch.kernels.dna_automaton import kernel, ops

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    def ms(fn, repeats=5):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / repeats

    table, accept = dfa_to_device(*ops.build_motif_dfa("ACGTAC"), "cuda")
    full = ops.random_dna_text(max(args.t), seed=0, device="cuda")
    for t in args.t:
        text = full[:t]
        bound_ms = t / HBM_BYTES_PER_S * 1e3
        for chunk in args.chunks:
            maps = kernel.state_map(text, table, chunk=chunk)
            starts = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                                ops.compose_maps(maps)[:-1, 0]])
            compose_ms = ms(lambda: ops.compose_maps(maps), 3)
            for bt in args.block_threads:
                map_ms = ms(lambda: kernel.state_map(
                    text, table, chunk=chunk, block_threads=bt))
                count_ms = ms(lambda: kernel.count_hits(
                    text, table, accept, starts, chunk=chunk, block_threads=bt))
                print(json.dumps({
                    "t": t, "chunk": chunk, "block_threads": bt,
                    "state_map_ms": map_ms, "count_hits_ms": count_ms,
                    "compose_maps_ms": compose_ms, "bound_ms": bound_ms,
                    "state_map_bound_share": bound_ms / map_ms,
                    "count_hits_bound_share": bound_ms / count_ms}), flush=True)
            del maps, starts
    return 0


if __name__ == "__main__":
    sys.exit(main())
