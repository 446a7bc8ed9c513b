"""End-to-end training through the PyTorch port: data -> train
step -> checkpoints (the twin of ``examples/train_lm.py``).

Presets:
  tiny (default) — the Qwen2.5-3B smoke config, 60 steps (a sanity run;
                   ``--device cpu`` runs it on the host).
  100m           — ~100M-parameter qwen-family model, 300 steps (the
                   deliverable-scale e2e run): ~45 s on an NVIDIA H100
                   80GB HBM3 at 700 W, 0.13 s a step, bound by the host's
                   ~4300 launches a step; every attention layer through
                   the flash-attention kernel and its backward kernels
                   (PERF.md, phase ``example_train_100m``).

    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --device cpu
    PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300
"""

import argparse
import dataclasses
import logging
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs, resolve_device
from repro_torch.launch.train import train_loop
from repro_torch.models.config import ArchConfig


def model_100m() -> ArchConfig:
    """Qwen-2.5-family block at ~100M params (108M with tied embeddings)."""
    return dataclasses.replace(
        configs.get("qwen2.5-3b"),
        name="qwen-family-100m",
        n_layers=10, d_model=768, n_heads=12, n_kv_heads=2, head_dim=64,
        d_ff=3072, vocab_size=32_000, layer_kinds=("attn",) * 10,
        tie_embeddings=True, logit_chunk=128,
    )


# steps between checkpoints (the reference's 50)
CKPT_EVERY = 50

PRESETS = {
    "tiny": dict(cfg=lambda: configs.get("qwen2.5-3b").smoke(),
                 steps=60, batch=8, seq_len=64),
    "100m": dict(cfg=model_100m, steps=300, batch=8, seq_len=256),
}


def main(argv=None, *, model=None) -> dict:
    """Train a preset; returns ``train_loop``'s result.  ``model`` carries
    weights in (a model of the preset's config); else one is built from
    seed 0 on ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=str(
        pathlib.Path(tempfile.gettempdir()) / "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    preset = PRESETS[args.preset]
    cfg = preset["cfg"]()
    print(f"model: {cfg.name}  params={cfg.param_count()/1e6:.1f}M")
    out = train_loop(
        cfg,
        steps_total=args.steps or preset["steps"],
        batch=args.batch or preset["batch"],
        seq_len=args.seq_len or preset["seq_len"],
        ckpt_dir=args.ckpt_dir, ckpt_every=CKPT_EVERY, log_every=10,
        model=model, device=None if model is not None
        else resolve_device(args.device))
    print(f"loss: {out['losses'][0]:.4f} -> {out['final_loss']:.4f} "
          f"over {len(out['losses'])} steps"
          + (f" (resumed from step {out['resumed_from']})"
             if out["resumed_from"] else ""))
    return out


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    main()
