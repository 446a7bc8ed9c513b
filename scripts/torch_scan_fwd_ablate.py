#!/usr/bin/env python3
"""Where the selective-scan forward spends its time.

    python3 scripts/torch_scan_fwd_ablate.py

Builds copies of ``kernels/csrc/mamba_scan.cu`` into ``build/`` with one
part of the kernel cut out each (the exp, an ex2 on the SFU, replaced by
an FMA; the B_t / C_t loads from shared memory; the x / delta loads from
shared memory; every device-memory copy, staging and y's stores; the
split lanes' reduce-scatter) and times each at the defaults of the Jamba
prefill shape (B 8, T 2048, dI 8192, S 16) and training shape (B 2), and
at four threads a channel at both, with CUDA events over 20 back-to-back
launches.  The cut copies compute wrong outputs: they are timings only.
Prints one JSON line per launch point, then each kernel's ptxas registers
and spills, then the card.
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

EXP = "h[r] = fmaf(ex2(dt * a2[r]), h[r], dtx * bv[r]);"
CUTS = {
    "whole": [],
    "no_exp": [(EXP, "h[r] = fmaf(fmaf(dt, a2[r], 1.f), h[r], dtx * bv[r]);")],
    "no_bc_loads": [
        ("load_row<R>(bq + k * S, bv);",
         "for (int r = 0; r < R; ++r) bv[r] = a2[r] * 0.5f;"),
        ("load_row<R>(cq + k * S, cv);",
         "for (int r = 0; r < R; ++r) cv[r] = a2[r] * 0.25f;")],
    "no_x_delta_loads": [
        # a different delta every token (g moves), so nothing is hoisted
        ("const float dt = *dq;", "const float dt = 1e-3f * (k + 1 + g);"),
        ("const float dtx = dt * *xk;", "const float dtx = dt * dd;")],
    "no_memory": [
        ("    stage_chunk(x, delta, Bm, Cm, smem, b, 0,",
         "    if (nc < 0) stage_chunk(x, delta, Bm, Cm, smem, b, 0,"),
        ("        if (c + 1 < nc) {", "        if (c + 1 < 0) {"),
        ("        if (d0 + sl.col < dI) {", "        if (d0 + sl.col < 0) {")],
    "no_reduce": [("reduce_scatter<SPLIT, SPLIT / 2, 1>(v + j, lane);", "")],
}
# (B, block_d, chunk, split): the defaults at B 8 and B 2
# (``ops.defaults``), then four threads a channel
POINTS = ((8, 128, 16, 1), (8, 64, 16, 4), (2, 64, 64, 2), (2, 32, 64, 4))


def build() -> dict:
    from repro_torch import _build

    src = (_build.CSRC_DIR / "mamba_scan.cu").read_text()
    out = _build.build_dir()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: the source no longer has {old!r} "
                                 "once")
            text = text.replace(old, new)
        cu = out / f"ablate_fwd_{name}.cu"
        cu.write_text(text)
        cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
               str(_build.CSRC_DIR), "-o", str(out / f"ablate_fwd_{name}.so"),
               str(cu)]
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

    t, di, s = 2048, 8192, 16
    libs = {}
    for name in CUTS:
        lib = ctypes.CDLL(str(out / f"ablate_fwd_{name}.so"))
        lib.mamba_scan_fwd.argtypes = ([ctypes.c_void_p] * 9
                                       + [ctypes.c_int] * 8
                                       + [ctypes.c_void_p])
        libs[name] = lib.mamba_scan_fwd
    stream = torch.cuda.current_stream().cuda_stream
    for bt in sorted({p[0] for p in POINTS}, reverse=True):
        x, dl = randn(bt, t, di), randn(bt, t, di).abs() * 0.1
        a = -(randn(di, s).abs() + 0.5)
        bm, cm, d, h0 = randn(bt, t, s), randn(bt, t, s), randn(di), \
            randn(bt, di, s)
        y, h_t = torch.empty_like(x), torch.empty_like(h0)
        ptrs = [m.data_ptr() for m in (x, dl, a, bm, cm, d, h0, y, h_t)]
        for b_, bd, chunk, split in POINTS:
            if b_ != bt:
                continue
            row = {"bt": bt, "block_d": bd, "chunk": chunk, "split": split}
            for name, fn in libs.items():
                args = (*ptrs, bt, t, di, s, bd, chunk, split, 1, stream)
                if fn(*args) != 0:
                    raise SystemExit(f"{name}: launch refused at {row}")
                row[f"{name}_ms"] = ms(lambda: fn(*args))
            print(json.dumps(row), flush=True)
        del x, dl, y
        torch.cuda.empty_cache()
    kernel = None
    for line in logs["whole"].splitlines():
        if "Compiling entry" in line:
            kernel = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and kernel \
                and "ILi16E" in kernel:
            print(f"{kernel[:90]}: {line.strip()}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
