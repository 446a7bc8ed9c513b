"""Batched serving through the PyTorch port: prefill a prompt batch,
decode with KV caches (the twin of ``examples/serve_lm.py``).  The
prefill runs the flash-attention kernel, each decoded token the
decode-attention kernel; ``--device cpu`` runs their plain versions.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch qwen2.5-3b \
        --smoke --batch 4 --prompt-len 32 --gen 24 [--device cpu]
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import serve


def main(argv=None) -> dict:
    """``repro_torch.launch.serve.main`` with ``--smoke`` inserted, as the
    reference inserts it; returns the session's result."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--smoke" not in argv:
        argv.insert(0, "--smoke")
    return serve.main(argv)


if __name__ == "__main__":
    main()
