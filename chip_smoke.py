#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--t SYMBOLS] [--seed N]

Drives the port's main path once, at full width, through the entry
points a user would call: build a motif DFA, ``tune_kernel`` the DNA
automaton's launch parameters on a text of 3 * 2^30 symbols resident on
the card (the paper's human genome is 3.17 GB), store the winner, then
``configure`` the store and answer five motif-count requests through
``fa_match(tuned=True)``.  Before that it builds the CUDA kernels from
``src/repro_torch/kernels/csrc/`` into ``build/`` and holds each kernel
against its plain PyTorch version on the same full-width inputs.

Each phase prints one JSON line; any failing phase raises, so the script
exits non-zero and prints no result line.  It needs one CUDA device and
exits non-zero without one.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

``bound_ms`` in the kernels line is the least time the card could take:
the larger of (bytes each input is read once + each output written once)
/ 3.35e12 B/s (H100 SXM HBM3 bandwidth, NVIDIA data sheet) and (one
integer table lookup per symbol and start state) / 33.5e12 op/s (the
data sheet's 67 TFLOP/s of non-tensor float32 counts a fused multiply-add
as two, so 33.5e12 instructions per second; the same rate is taken for
int32 instructions).
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

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FULL_T = 3 * 2 ** 30
HBM_BYTES_PER_S = 3.35e12
INT_OPS_PER_S = 33.5e12
SERVE_MOTIFS = ("ACGTAC", "GATTAC", "TTAGGG", "CCGGAA", "ACGTACGT")


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def device_ms(fn, repeats: int) -> float:
    """Mean device time of ``fn`` over ``repeats`` launches (CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def max_abs_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)
    return smi


def phase_build() -> None:
    from repro_torch import _build

    t0 = time.perf_counter()
    _build.load_library("dna_automaton")
    emit(phase="build", seconds=round(time.perf_counter() - t0, 3),
         library=str(_build.library_path("dna_automaton").relative_to(ROOT)),
         flags=" ".join(_build.NVCC_FLAGS))


def phase_oracle(seed: int) -> None:
    """Kernel path vs the sequential oracle vs the plain path: exact."""
    from repro_torch.kernels.dna_automaton import ops, ref

    cases = []
    text = ops.random_dna_text(2 ** 20, seed=seed, device="cuda")
    small = text[:10000].contiguous()
    for motif in ("ACGTAC", "AAAA"):
        table, accept = ops.build_motif_dfa(motif)
        for txt, chunk in ((text, 2048), (small, 512)):   # 512 clamps to 500
            got = int(ops.fa_match(txt, table, accept, chunk=chunk,
                                   tuned=False))
            plain = int(ops.fa_match_plain(txt, table, accept, chunk=chunk))
            want, _ = ref.fa_match_ref(txt, table, accept)
            check(got == want == plain,
                  f"oracle: motif {motif} t={txt.shape[0]} chunk={chunk}: "
                  f"kernel {got}, plain {plain}, sequential {want}")
            cases.append({"motif": motif, "t": txt.shape[0], "chunk": chunk,
                          "count": got})
    emit(phase="oracle", ok=True, cases=cases)


def phase_kernels(text) -> list[dict]:
    """Each kernel at the default launch parameters against its plain
    version on the full-width text; returns the kernels' records (their
    ``launches`` are filled in after the main path ran)."""
    from repro_torch.convert import dfa_to_device
    from repro_torch.kernels.dna_automaton import kernel, ops

    chunk, bt = ops.DEFAULTS["map_chunk"], ops.DEFAULTS["block_threads"]
    table, accept = dfa_to_device(*ops.build_motif_dfa("ACGTAC"), "cuda")
    t, s = text.shape[0], table.shape[0]
    n_chunks = t // chunk
    source = "src/repro_torch/kernels/csrc/dna_automaton.cu"

    def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
        by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
        by_ops = n_ops / INT_OPS_PER_S * 1e3
        return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                       else "operations")

    # -- dna_state_map
    maps = kernel.state_map(text, table, chunk=chunk, block_threads=bt)
    torch.cuda.synchronize()
    ms = device_ms(lambda: kernel.state_map(text, table, chunk=chunk,
                                            block_threads=bt), 5)
    holder = {}
    plain_ms = device_ms(lambda: holder.update(
        maps=kernel.state_map_plain(text, table, chunk=chunk)), 1)
    ok = torch.equal(maps, holder["maps"])
    b_ms, b_by = bound(t + 4 * table.numel() + 4 * n_chunks * s, t * s)
    records = [{
        "name": "dna_state_map", "ok": ok, "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/dna_automaton/kernel.py:54",
        "launches": 0, "max_abs_err": max_abs_err([maps], [holder["maps"]]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]

    # -- dna_count_hits, from each chunk's true start state
    prefix = ops.compose_maps(maps)
    starts = torch.cat([torch.zeros(1, dtype=torch.int32, device="cuda"),
                        prefix[:-1, 0]])
    del prefix, holder
    compose_ms = device_ms(lambda: ops.compose_maps(maps), 3)
    got = kernel.count_hits(text, table, accept, starts, chunk=chunk,
                            block_threads=bt)
    torch.cuda.synchronize()
    ms = device_ms(lambda: kernel.count_hits(text, table, accept, starts,
                                             chunk=chunk, block_threads=bt), 5)
    holder = {}
    plain_ms = device_ms(lambda: holder.update(out=kernel.count_hits_plain(
        text, table, accept, starts, chunk=chunk)), 1)
    want = holder["out"]
    ok = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b_ms, b_by = bound(t + 4 * table.numel() + 4 * s + 3 * 4 * n_chunks, t)
    records.append({
        "name": "dna_count_hits", "ok": ok, "route": "cuda", "source": source,
        "replaces": "src/repro/kernels/dna_automaton/kernel.py:94",
        "launches": 0, "max_abs_err": max_abs_err(got, want),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None})

    # where one fa_match at the defaults spends its time: the two kernels
    # above, the plain-PyTorch prefix compose between them, and the rest
    ops.fa_match(text, table, accept, tuned=False)      # warm the allocator
    fa_match_ms = device_ms(lambda: ops.fa_match(text, table, accept,
                                                 tuned=False), 3)
    emit(phase="kernel_parity", t=t, chunk=chunk, block_threads=bt,
         total_count=int(got[0].sum()), compose_maps_ms=compose_ms,
         fa_match_default_ms=fa_match_ms,
         results=[{k: r[k] for k in ("name", "ok", "max_abs_err", "ms",
                                     "plain_ms", "bound_ms")}
                  for r in records])
    for r in records:
        check(r["ok"], f"{r['name']} disagrees with its plain version "
                       f"(max abs err {r['max_abs_err']})")
    return records


def phase_tune(t: int, seed: int, store_path: Path):
    from repro_torch.tune import kernels as ktune

    t0 = time.perf_counter()
    out = ktune.tune_kernel("dna_automaton", {"t": t}, store=store_path,
                            seed=seed)
    seconds = time.perf_counter() - t0
    default_s, best_s = out.default_time(), out.best_time()
    check(not out.result.from_cache, "tune: first tune came from the cache")
    check(out.n_measured <= 25, f"tune: measured {out.n_measured} > 25")
    check(out.measured_fraction <= 0.05,
          f"tune: measured fraction {out.measured_fraction} > 0.05")
    check(out.timer.n_launch_failed == 0,
          f"tune: {out.timer.n_launch_failed} launches refused: "
          f"{out.timer.rejected}")
    check(best_s <= default_s,
          f"tune: best {best_s} s slower than default {default_s} s")
    again = ktune.tune_kernel("dna_automaton", {"t": t}, store=store_path,
                              seed=seed)
    check(again.result.from_cache and again.n_measured == 0,
          "tune: repeat was not a zero-measurement cache hit")
    check(again.best_config == out.best_config, "tune: cached config differs")
    emit(phase="tune", ok=True, seconds=round(seconds, 3),
         space_size=out.space_size, n_measured=out.n_measured,
         measured_fraction=out.measured_fraction,
         n_launch_failed=out.timer.n_launch_failed,
         default_config=out.default_config, default_ms=default_s * 1e3,
         best_config=out.best_config, best_ms=best_s * 1e3,
         repeat_from_cache=again.result.from_cache,
         repeat_n_measured=again.n_measured)
    return out


def phase_serve(text, store_path: Path, tuned) -> None:
    from repro_torch.kernels.dna_automaton import kernel, ops
    from repro_torch.tune import kernels as ktune

    ktune.configure(store_path)
    n_measured = tuned.timer.n_measured
    t = text.shape[0]
    requests = []
    for motif in SERVE_MOTIFS:
        table, accept = ops.build_motif_dfa(motif)
        resolved = ktune.resolve_config(
            "dna_automaton", {"t": t, "s": table.shape[0]}, "uint8",
            device="cuda")
        hit = table.shape[0] == tuned.shape["s"]
        check(resolved == (tuned.best_config if hit else {}),
              f"serve: motif {motif} resolved {resolved}")
        before = (kernel.state_map.launches, kernel.count_hits.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = int(ops.fa_match(text, table, accept, tuned=True))
        seconds = time.perf_counter() - t0
        after = (kernel.state_map.launches, kernel.count_hits.launches)
        check(after == (before[0] + 1, before[1] + 1),
              f"serve: launch counters went {before} -> {after}")
        want = int(ops.fa_match_plain(text, table, accept))
        check(count == want,
              f"serve: motif {motif}: kernel path {count}, plain path {want}")
        requests.append({"motif": motif, "store_hit": hit, "count": count,
                         "ms": seconds * 1e3, "symbols_per_s": t / seconds})
    check(tuned.timer.n_measured == n_measured,
          "serve: answering requests measured new configurations")
    ktune.disable()
    emit(phase="serve", ok=True, requests=requests)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=FULL_T,
                    help="symbols of DNA text (default: 3 * 2**30)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from repro_torch.kernels.dna_automaton import kernel, ops

    smi = phase_env()
    phase_build()
    phase_oracle(args.seed)
    text = ops.random_dna_text(args.t, seed=args.seed, device="cuda")
    records = phase_kernels(text)

    # the main path: every launch counter starts from 0 just before it
    kernel.state_map.launches = 0
    kernel.count_hits.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        store_path = Path(tmp) / "kernels.json"
        tuned = phase_tune(args.t, args.seed, store_path)
        phase_serve(text, store_path, tuned)
    launches = {"dna_state_map": kernel.state_map.launches,
                "dna_count_hits": kernel.count_hits.launches}
    for r in records:
        r["launches"] = launches[r["name"]]
        check(r["launches"] > 0, f"{r['name']} was never launched on the "
                                 "main path")
    torch.cuda.synchronize()

    emit(kernels=records)
    print(smi, flush=True)
    emit(ok=True, device={"platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
