#!/usr/bin/env python3
"""Where the selective-scan backward's chunk program spends its time.

    python3 scripts/torch_scan_bwd_ablate.py

Builds copies of ``kernels/csrc/mamba_scan_bwd.cu`` into ``build/`` with
one part of the chunk program cut out each (the dB/dC reduce-scatter over
the channel lanes, the per-token sums' reduce-scatter over the part lanes,
both, the dx/ddelta stores) and times the chunk program of each at the
Jamba training shape (B 2, T 2048, dI 8192, S 16) at a few launch points,
with CUDA events over 20 back-to-back launches.  The cut copies compute
wrong gradients: they are timings only.  Prints one JSON line per launch
point, then each kernel's ptxas registers and spills, then the card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

RS_V = "        const int first = reduce_scatter<NV, 16, SPLIT>(v, lane);"
RS_U = "        const int first2 = reduce_scatter<NU, SPLIT / 2, 1>(u, lane);"
OUT = "        for (int e = tid; e < nv * block_d; e += nth) {\n"
CUTS = {
    "whole": [],
    "no_dB_dC_reduce": [(RS_V, "        const int first = 0;")],
    "no_token_sums_reduce": [(RS_U, "        const int first2 = 0;")],
    "no_reduces": [(RS_V, "        const int first = 0;"),
                   (RS_U, "        const int first2 = 0;")],
    "no_dx_stores": [(OUT, "        for (int e = tid; e < 0; e += nth) {\n")],
}
POINTS = ((32, 16, 4, 8), (64, 16, 4, 8), (32, 8, 8, 16), (32, 16, 8, 16))


def build() -> dict:
    from repro_torch import _build

    src = (_build.CSRC_DIR / "mamba_scan_bwd.cu").read_text()
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: the source no longer has {old!r}")
            text = text.replace(old, new)
        cu = out / f"ablate_{name}.cu"
        cu.write_text(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out / f"ablate_{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    logs = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{stderr[-4000:]}")
        logs[name] = stdout + stderr
    return logs


def ms(fn, n: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    logs = build()
    out = ROOT / "build"
    gen = torch.Generator("cuda")
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    bt, t, di, s = 2, 2048, 8192, 16
    x, dl = randn(bt, t, di), randn(bt, t, di).abs() * 0.1
    a = -(randn(di, s).abs() + 0.5)
    bm, cm, d, dy = randn(bt, t, s), randn(bt, t, s), randn(di), randn(bt, t, di)
    stream = torch.cuda.current_stream().cuda_stream
    libs = {}
    for name in CUTS:
        lib = ctypes.CDLL(str(out / f"ablate_{name}.so"))
        lib.mamba_scan_bwd_chunks.argtypes = ([ctypes.c_void_p] * 17
                                              + [ctypes.c_int] * 8
                                              + [ctypes.c_void_p])
        libs[name] = lib.mamba_scan_bwd_chunks
    for bd, chunk, split, span in POINTS:
        n = -(-t // chunk)
        ns = -(-n // span)
        pc, hc = (torch.rand((bt, n, di, s), device="cuda") for _ in range(2))
        hs, gs, da = (torch.rand((bt, ns, di, s), device="cuda")
                      for _ in range(3))
        dx, ddt = torch.empty_like(x), torch.empty_like(x)
        db = torch.empty((-(-di // bd), bt, t, s), device="cuda")
        dc = torch.empty_like(db)
        dd = torch.empty((bt, ns, di), device="cuda")
        ptrs = [m.data_ptr() for m in (x, dl, a, bm, cm, d, dy, pc, hc, hs,
                                       gs, dx, ddt, da, db, dc, dd)]
        row = {"block_d": bd, "chunk": chunk, "split": split, "span": span}
        for name, fn in libs.items():
            args = (*ptrs, bt, t, di, s, bd, chunk, split, span, stream)
            if fn(*args) != 0:
                raise SystemExit(f"{name}: launch refused at {row}")
            row[f"{name}_ms"] = ms(lambda: fn(*args))
        print(json.dumps(row), flush=True)
    kernel = None
    for line in logs["whole"].splitlines():
        if "Compiling entry" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and kernel \
                and "chunks_kernel" in kernel:
            print(f"{kernel[:90]}: {line.strip()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
