"""Production-mesh dry run: one step of every (arch x shape x mesh) cell on
meta tensors, as rank 0 of the mesh sees it.

The reference lowers and compiles each cell's jitted step against 512
placeholder devices.  The port runs the step itself, eagerly, on the
``meta`` device (shapes only), in one process standing as rank 0 of a
``torch.distributed`` "fake" process group the size of the production
mesh: (data 16, model 16) for ``single``, (pod 2, data 16, model 16) for
``multi``.  The fake group accepts every collective on meta tensors and
moves nothing.  For each applicable cell ``run_cell``:

  1. builds the step (``launch.steps.make_{train,prefill,serve}_step``)
     under the default policy (``launch.policies``): the model sharded
     over the mesh as its run would shard it, its state and rank 0's rows
     of the batch, all on meta;
  2. runs it once (``StepBundle.dry_run``, ``launch.meta_trace``) with
     ``dist.collectives.ROUTE`` forced to ``"native"``: on a production
     mesh every rank has its own card, so NCCL's own all-gather and
     reduce-scatter run (not the all-reduce construction of ranks that
     share a card);
  3. records the parameter, moment and peak live bytes of the rank, the
     FLOPs (the PyTorch operations' counted by ``FlopCounterMode`` plus
     the kernels' from the kernel census), the kernel census by wrapper
     and program, and the collective census of ``COUNTERS``
     (``roofline.census``).

It restores the process-group state and the counters it found.  Results
go to ``results/dryrun_torch.json`` (one record per cell, replaced when
run again).  No card is needed.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from .. import configs
from ..dist import collectives
from ..dist.ranks import RankMesh
from ..roofline.census import collective_census
from . import policies, shapes, steps

__all__ = ["append_result", "build_bundle", "fake_ranks", "measure",
           "mesh_shape", "run_cell"]

RESULTS = Path(__file__).resolve().parents[3] / "results"


def mesh_shape(mesh_name: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The production mesh's (shape, axes) for ``"single"``/``"multi"``."""
    if mesh_name == "multi":
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


@contextlib.contextmanager
def fake_ranks(shape: tuple[int, ...], axes: tuple[str, ...]):
    """Rank 0's ``RankMesh`` of ``shape`` over a fake process group, with
    the native collective route; on exit the group is destroyed and the
    route and ``COUNTERS`` are as they were.  Refuses to run where a
    process group is already running (it would replace it)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a dry run needs a process without a running "
                           "process group")
    route, counts = collectives.ROUTE[0], collectives.COUNTERS.by
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        collectives.ROUTE[0] = "native"
        collectives.COUNTERS.reset()
        yield RankMesh(init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=tuple(axes)))
    finally:
        collectives.ROUTE[0] = route
        collectives.COUNTERS.by = counts
        dist.destroy_process_group()


def build_bundle(arch_name: str, cell: shapes.ShapeCell, mesh,
                 scfg=None, cfg=None) -> steps.StepBundle:
    """The cell's step under ``scfg`` (default: the default policy) for
    ``cfg`` (default: the arch's config as ``policies.arch_for_cell``
    sets it for the cell)."""
    cfg = cfg or policies.arch_for_cell(configs.get(arch_name), cell)
    scfg = scfg or policies.default_sharding(cfg, cell)
    if cell.kind == "train":
        batch = shapes.batch_specs_for(cfg, cell)
        return steps.make_train_step(cfg, scfg, mesh,
                                     policies.default_opt(cfg), batch)
    if cell.kind == "prefill":
        batch = shapes.batch_specs_for(cfg, cell)
        return steps.make_prefill_step(cfg, scfg, mesh, batch,
                                       max_len=cell.seq_len)
    return steps.make_serve_step(cfg, scfg, mesh, cell.global_batch,
                                 cell.seq_len)


def measure(bundle: steps.StepBundle, mesh) -> dict:
    """``bundle.dry_run()`` with the collectives it issues: the record's
    ``memory``, ``flops``, ``kernels`` and ``collectives``."""
    collectives.COUNTERS.reset()
    out = bundle.dry_run()
    counts = collectives.COUNTERS.snapshot()
    return {
        "step_s": out["seconds"],
        "memory": {
            "param_bytes": out["param_bytes"],
            "moment_bytes": out["moment_bytes"],
            "resident_bytes": out["resident_bytes"],
            "peak_bytes": out["peak_bytes"],
            "peak_per_device_gb": out["peak_bytes"] / 2**30,
        },
        "flops": {"torch": out["torch_flops"],
                  "kernels": out["kernel_flops"],
                  "total": out["torch_flops"] + out["kernel_flops"]},
        "kernels": out["kernels"],
        "counters": counts,
        "collectives": collective_census(counts, mesh),
    }


def run_cell(arch_name: str, cell: shapes.ShapeCell, mesh_name: str,
             scfg=None, shape: tuple[int, ...] | None = None,
             axes: tuple[str, ...] | None = None) -> dict:
    """One cell's dry run on rank 0's view of the production mesh
    ``mesh_name`` (or of ``shape`` over ``axes``)."""
    if shape is None:
        shape, axes = mesh_shape(mesh_name)
    rec: dict = {"arch": arch_name, "cell": cell.name, "mesh": mesh_name,
                 "n_devices": math.prod(shape)}
    t0 = time.perf_counter()
    try:
        with fake_ranks(shape, axes) as mesh:
            bundle = build_bundle(arch_name, cell, mesh, scfg)
            rec.update(measure(bundle, mesh))
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-2000:]})
    rec["seconds"] = time.perf_counter() - t0
    return rec


def append_result(rec: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    existing = []
    if path.exists():
        existing = json.loads(path.read_text())
    existing = [r for r in existing
                if not (r["arch"] == rec["arch"] and r["cell"] == rec["cell"]
                        and r["mesh"] == rec["mesh"])]
    existing.append(rec)
    path.write_text(json.dumps(existing, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=configs.ARCH_NAMES)
    ap.add_argument("--shape", default=None, choices=list(shapes.SHAPE_CELLS))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(RESULTS / "dryrun_torch.json"))
    args = ap.parse_args(argv)

    archs = list(configs.ARCH_NAMES) if (args.all or not args.arch) \
        else [args.arch]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    out = Path(args.out)

    n_ok = n_fail = n_skip = 0
    t0 = time.perf_counter()
    for arch_name in archs:
        cfg = configs.get(arch_name)
        for cell in shapes.SHAPE_CELLS.values():
            if args.shape and cell.name != args.shape:
                continue
            ok, reason = shapes.applicable(cfg, cell)
            if not ok:
                print(f"SKIP  {arch_name} x {cell.name}: {reason}")
                n_skip += 1
                continue
            for mesh_name in meshes:
                rec = run_cell(arch_name, cell, mesh_name)
                append_result(rec, out)
                if rec["ok"]:
                    n_ok += 1
                    print(f"OK    {arch_name} x {cell.name} x {mesh_name}: "
                          f"{rec['seconds']:.1f}s peak/dev "
                          f"{rec['memory']['peak_per_device_gb']:.3f} GiB "
                          f"flops {rec['flops']['total']:.3e}", flush=True)
                else:
                    n_fail += 1
                    print(f"FAIL  {arch_name} x {cell.name} x {mesh_name}: "
                          f"{rec['error']}", flush=True)
    print(f"\ndone: {n_ok} ok, {n_fail} failed, {n_skip} skipped "
          f"in {time.perf_counter() - t0:.1f}s -> {out}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
