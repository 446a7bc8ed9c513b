#!/usr/bin/env python3
"""B4's output bits against another checkout's B4, and its lse output.

    python3 scripts/torch_b4_lse_bits.py --parent DIR [--out FILE]

``DIR`` is a checkout (``git archive``) of another commit, typically the
parent of a change to ``decode_attention.cu``.  Each tree's
``repro_torch`` builds its own decode-attention library (into its own
``build/``) in a child process and runs B4 through the wrapper
(``kernels/decode_attention/ops.py``, the default launch points) on the
same seeded inputs: the Qwen2.5-3B decode shape at three fills, the
sequence-sharded decode's stripes (16384 and 8208 positions), hd 96, 192,
64 and 32, bf16 and float32 caches.  Every output must be bit-equal
between the two trees; in this tree ``return_lse=True`` must give the same
output bits and an lse within 1e-4 of the plain version's.  Prints one
JSON line (and writes it to ``FILE``); exits non-zero on a difference.
Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

# (dtype, B, KV, rep, hd, S, length)
CASES = (("bf16", 8, 2, 8, 128, 2176, 2049), ("bf16", 8, 2, 8, 128, 2176, 2176),
         ("bf16", 8, 2, 8, 128, 2176, 37), ("bf16", 8, 2, 8, 128, 16384, 16384),
         ("bf16", 8, 2, 8, 128, 16384, 1), ("bf16", 1, 2, 8, 128, 8208, 8208),
         ("bf16", 1, 2, 8, 128, 8208, 8175), ("bf16", 8, 32, 1, 96, 2176, 2049),
         ("bf16", 1, 8, 12, 192, 2176, 1000), ("bf16", 4, 2, 3, 32, 64, 38),
         ("f32", 2, 2, 4, 64, 1000, 777), ("f32", 8, 2, 8, 128, 16384, 9000))


def emit_outputs(out_path: str, with_lse: bool) -> None:
    """Run every case with the importable ``repro_torch``; save outputs."""
    import torch

    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.decode_attention import ops as da_ops

    saved = {}
    for i, (dt, b, kv, rep, hd, s, length) in enumerate(CASES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator("cuda")
        gen.manual_seed(1000 + i)
        q = torch.randn((b, kv * rep, hd), generator=gen,
                        device="cuda").to(dtype)
        k, v = (torch.randn((b, s, kv, hd), generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        out = da_ops.decode_attention(q, k, v, length=length)
        saved[i] = {"out": out.cpu()}
        if with_lse:
            o2, lse = da_ops.decode_attention(q, k, v, length=length,
                                              return_lse=True)
            _, lse_p = dak.decode_attention_plain(
                q.view(b, kv, rep, hd), k, v, length, return_lse=True)
            saved[i].update(same_with_lse=bool(torch.equal(o2, out)),
                            lse_err=float((lse - lse_p).abs().max()))
    torch.save(saved, out_path)


def run_tree(src: Path, out_path: Path, with_lse: bool) -> None:
    env = dict(os.environ, PYTHONPATH=str(src))
    cmd = [sys.executable, __file__, "--emit", str(out_path)]
    if with_lse:
        cmd.append("--with-lse")
    subprocess.run(cmd, env=env, check=True, cwd=src.parent)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of the other commit")
    ap.add_argument("--out", default=None)
    ap.add_argument("--emit", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--with-lse", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.emit:
        emit_outputs(args.emit, args.with_lse)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_b4_lse_bits: no CUDA device", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parents[1] / "src"
    with tempfile.TemporaryDirectory() as tmp:
        mine, theirs = Path(tmp) / "mine.pt", Path(tmp) / "theirs.pt"
        run_tree(Path(args.parent).resolve() / "src", theirs, False)
        run_tree(here, mine, True)
        a = torch.load(mine, weights_only=False)
        b = torch.load(theirs, weights_only=False)
    cases = []
    for i, case in enumerate(CASES):
        cases.append({"case": case,
                      "bit_equal_to_parent": bool(torch.equal(a[i]["out"],
                                                              b[i]["out"])),
                      "same_with_lse": a[i]["same_with_lse"],
                      "lse_max_abs_err": a[i]["lse_err"]})
    ok = all(c["bit_equal_to_parent"] and c["same_with_lse"]
             and c["lse_max_abs_err"] <= 1e-4 for c in cases)
    line = json.dumps({"script": "torch_b4_lse_bits", "ok": ok,
                       "device": torch.cuda.get_device_name(0),
                       "cases": cases})
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
