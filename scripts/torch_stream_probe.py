#!/usr/bin/env python3
"""The streamed host/card split alone: ``chip_smoke.py``'s DNA tune and its
phase ``stream``, without the other paths.

    python3 scripts/torch_stream_probe.py [--t SYMBOLS] [--seed N]

Builds only the DNA kernels, makes the text on the card, tunes B1/B2 at
its length into a store (phase ``tune``), then runs phase ``stream``: the
text copied back into pinned host memory, the paper's split space tuned,
every batch streamed through ``serve_stream`` and checked row by row, and
the card alone, the bare copy and the resident ``fa_match`` beside it.
Each phase prints its JSON line, then the card's name and power limit.
About a minute on an H100; needs one CUDA device.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=cs.FULL_T)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stream_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import _build
    from repro_torch.kernels.dna_automaton import ops

    smi = cs.phase_env()
    _build.load_libraries(("dna_automaton",))
    text = ops.random_dna_text(args.t, seed=args.seed, device="cuda")
    with tempfile.TemporaryDirectory(prefix="stream_probe_") as tmp:
        store = Path(tmp) / "kernels.json"
        cs.phase_tune(args.t, args.seed, store)
        cs.phase_stream(text, store, args.seed)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
