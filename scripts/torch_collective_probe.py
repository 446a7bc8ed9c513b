#!/usr/bin/env python3
"""The all-gather and the reduce-scatter of ``repro_torch.dist.collectives``
on ranks that share one card, against gloo's own ops on host copies.

    python3 scripts/torch_collective_probe.py [--out FILE] [--sizes MB ...]

Four ranks on a (2, 2) mesh over ("data", "model") share the card (gloo,
a file rendezvous); each rank's block of float32 is gathered along dim 0
over ``data``, ``model`` and both, and the gathered buffer is
reduce-scattered back, by the port's gloo route (``gather_raw``/
``scatter_raw``: an all-reduce of a zero-filled whole buffer; for the
scatter, an all-reduce then a slice) and staged through host memory
(``.cpu()``, gloo's own all-gather / reduce-scatter of the blocks on the
CPU, back to the card: fewer bytes between the ranks).  The two run in
turns (allreduce, staged, staged, allreduce) ``--repeats`` times at each
size; each call between two synchronizes on the host clock.  Both must
give the same bits.  Prints one JSON line a case (and appends them to
``FILE``) with the median seconds and the gathered buffer's GB/s of each,
the card's name and power limit.  Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

AXES = (("data",), ("model",), ("data", "model"))
ROUTES = ("allreduce", "staged")


def timed(fn) -> tuple[float, torch.Tensor]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def staged_gather(x, mesh, axes):
    """gloo's all-gather of host copies along dim 0, back on the card."""
    import torch.distributed as dist

    src = x.cpu()
    buf = torch.empty((mesh.axes_size(axes) * src.shape[0],
                       *src.shape[1:]), dtype=src.dtype)
    dist.all_gather_into_tensor(buf, src, group=mesh.group(axes))
    return buf.to(x.device)


def staged_scatter(x, mesh, axes):
    """gloo's reduce-scatter of a host copy along dim 0, back on the card."""
    import torch.distributed as dist

    src = x.cpu()
    out = torch.empty((src.shape[0] // mesh.axes_size(axes),
                       *src.shape[1:]), dtype=src.dtype)
    dist.reduce_scatter_tensor(out, src, group=mesh.group(axes))
    return out.to(x.device)


def rank_main(rank: int, world: int, init_file: str, sizes, repeats: int,
              out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.dist import collectives as c
    from repro_torch.dist.ranks import init_ranks
    from repro_torch.launch.mesh import make_host_mesh

    init_ranks(rank, world, init_method=f"file://{init_file}",
               device_type="cuda", timeout_s=300)
    try:
        mesh = make_host_mesh(axes=("data", "model"), shape=(2, 2))
        gen = torch.Generator("cuda")
        gen.manual_seed(rank)
        cases = []
        for mb in sizes:
            for axes in AXES:
                n = mesh.axes_size(axes)
                block = torch.randn((mb * 2 ** 18 // n, 1), generator=gen,
                                    device="cuda")
                times = {r: {"gather": [], "scatter": []} for r in ROUTES}
                results = {}
                for turn in range(repeats):
                    order = ROUTES if turn % 2 == 0 else ROUTES[::-1]
                    for route in order + order[::-1]:
                        if route == "allreduce":
                            tg, whole = timed(lambda: c.gather_raw(
                                block, mesh, axes, 0))
                            ts, back = timed(lambda: c.scatter_raw(
                                whole, mesh, axes, 0))
                        else:
                            tg, whole = timed(lambda: staged_gather(
                                block, mesh, axes))
                            ts, back = timed(lambda: staged_scatter(
                                whole, mesh, axes))
                        times[route]["gather"].append(tg)
                        times[route]["scatter"].append(ts)
                        results[route] = (whole, back)
                (wa, ba), (ws, bs) = results["allreduce"], results["staged"]
                nbytes = wa.numel() * wa.element_size()
                case = {"mb": mb, "axes": list(axes), "ranks": n,
                        "whole_bytes": nbytes,
                        "equal": bool(torch.equal(wa, ws)
                                      and torch.equal(ba, bs))}
                for route in ROUTES:
                    for op in ("gather", "scatter"):
                        med = statistics.median(times[route][op])
                        case[f"{route}_{op}_s"] = med
                        case[f"{route}_{op}_gbps"] = nbytes / med / 1e9
                cases.append(case)
                del block, wa, ba, ws, bs, results
                torch.cuda.empty_cache()
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(cases))
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[16, 256, 1024],
                    help="MB of the gathered float32 buffer")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_collective_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    world = 4
    with tempfile.TemporaryDirectory(prefix="collective_probe_") as tmp:
        mp.start_processes(rank_main, args=(
            world, str(Path(tmp) / "rendezvous"), args.sizes, args.repeats,
            tmp), nprocs=world, join=True, start_method="spawn")
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
    ok = True
    for i, case in enumerate(ranks[0]):
        line = {**case, "card": smi,
                "slowest_rank": {k: max(r[i][k] for r in ranks)
                                 for k in case if k.endswith("_s")},
                "equal_on_every_rank": all(r[i]["equal"] for r in ranks)}
        ok &= line["equal_on_every_rank"]
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
