"""Fault tolerance + elastic scaling demo on the ranks of a
``torch.distributed`` group (the twin of ``examples/elastic_restart.py``).

Phase 1: train with an injected failure at step 7 on a mesh of every
rank (FSDP over data when there are two or more); the supervisor restarts
from the latest atomic checkpoint and finishes — the parameters match an
uninterrupted run bitwise.
Phase 2: restore the final checkpoint onto a SMALLER mesh, over the first
half of the ranks (elastic shrink), and keep training; the other ranks
take no part.  One process alone is one rank and skips phase 2, as the
reference does with one device.

Run under torchrun, the ranks on the card (ranks sharing one card join
through gloo) or on the CPU:
    PYTHONPATH=src torchrun --nproc-per-node 2 \
        examples/torch_elastic_restart.py [--device cpu]
"""

import argparse
import logging
import os
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch.distributed as dist

from repro_torch import configs, resolve_device
from repro_torch.dist.fault import run_with_restarts
from repro_torch.dist.sharding import ShardingConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import train_loop

RUN = dict(batch=8, seq_len=32, log_every=4)


def smoke_cfg():
    return configs.get("qwen2.5-3b").smoke()


def sharding(n_ranks: int) -> ShardingConfig:
    return ShardingConfig(data_axes=("data",), model_axes=(),
                          fsdp_axes=("data",) if n_ranks > 1 else (),
                          remat=False)


def shared_tmpdir() -> str:
    """A new checkpoint directory, made by rank 0 and named to every
    rank (rank 0 writes the checkpoints; every rank reads them)."""
    name = [tempfile.mkdtemp(prefix="elastic_")
            if not dist.is_initialized() or dist.get_rank() == 0 else None]
    if dist.is_initialized():
        dist.broadcast_object_list(name, src=0)
    return name[0]


def main(argv=None) -> dict:
    """Both phases; returns ``{"phase1": RestartReport, "phase2":
    train_loop's result on this rank (``None`` when skipped), "ckpt_dir"}``.
    Joins the group the environment names (torchrun) when none is
    running; without one, runs as one rank."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_cfg()
    ranked = dist.is_initialized() or "WORLD_SIZE" in os.environ
    mesh = make_host_mesh(device=dev) if ranked else None
    n = mesh.size if mesh is not None else 1
    lead = mesh is None or dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"ranks: {n}")
    ckpt = shared_tmpdir()
    scfg = sharding(n)

    say("\n--- phase 1: injected failure at step 7, supervised restart ---")
    report = run_with_restarts(
        lambda **kw: train_loop(cfg, **kw),
        ckpt_dir=ckpt, fail_at_step=7,
        steps_total=12, ckpt_every=4, mesh=mesh, scfg=scfg, device=dev,
        **RUN)
    say(f"attempts: {report.attempts}; failures: {report.failures}")
    say(f"resumed from step {report.result['resumed_from']}; "
        f"final loss {report.result['final_loss']:.4f}")

    out = None
    if n >= 2:
        say("\n--- phase 2: elastic shrink to half the ranks ---")
        out = train_loop(cfg, steps_total=16, ckpt_dir=ckpt, ckpt_every=100,
                         mesh=make_host_mesh(n // 2, device=dev), scfg=scfg,
                         device=dev, **RUN)
        if mesh.rank < n // 2:                # a rank of the smaller mesh
            say(f"resumed from step {out['resumed_from']} on {n//2} "
                f"ranks; final loss {out['final_loss']:.4f}")
    return {"phase1": report, "phase2": out, "ckpt_dir": ckpt}


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    main()
