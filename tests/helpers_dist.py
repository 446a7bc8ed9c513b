"""Multi-rank helpers for the ``tests/test_torch_dist_*.py`` files.

``run_ranks`` spawns ``world`` CPU ranks (``torch.multiprocessing``,
``spawn``), joined through a ``file://`` rendezvous in the test's
``tmp_path`` (no port to collide under ``pytest-xdist``), each with one
thread and a mesh of ``shape`` over ``axes``; every rank runs
``fn(rank, world, mesh, *args)``.  A rank that raises fails the test, and
a run that outlives ``timeout`` seconds is killed and fails it, so a
collective that hangs costs one test, not the suite.

The rank functions live here, not in the test modules: a spawned rank
imports the module of the function it runs, and a rank never imports
``jax`` (the test modules do).  They write what they computed with
``torch.save`` for the test to hold against the reference.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

RANK_TIMEOUT_S = 60.0


def _rank_main(rank, world, init_file, shape, axes, fn, args):
    import torch.distributed as dist

    from repro_torch.dist.ranks import init_ranks
    from repro_torch.launch.mesh import make_host_mesh

    init_ranks(rank, world, init_method=f"file://{init_file}",
               device_type="cpu", timeout_s=RANK_TIMEOUT_S)
    try:
        mesh = make_host_mesh(axes=axes, shape=shape, device="cpu")
        fn(rank, world, mesh, *args)
        if "jax" in sys.modules:
            raise AssertionError(f"rank {rank} imported jax")
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, tmp_path: Path, *, shape: tuple,
              axes: tuple, args: tuple = (),
              timeout: float = RANK_TIMEOUT_S) -> None:
    init_file = Path(tmp_path) / f"rendezvous_{time.monotonic_ns()}"
    ctx = mp.start_processes(_rank_main, args=(world, str(init_file), shape,
                                               axes, fn, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} still "
                                   f"running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


# -- rank functions ----------------------------------------------------------------

def allreduce_rank(rank, world, mesh, x_path, out_path):
    """``compressed_allreduce_mean`` of row ``rank`` of the saved matrix
    under each scheme; rank 0 writes what every rank got back."""
    import json

    from repro_torch.dist.compression import compressed_allreduce_mean

    x = torch.from_numpy(np.load(x_path))[rank:rank + 1]
    out = {}
    for scheme in ("int8", "topk", "none"):
        got = compressed_allreduce_mean(x, mesh, "data", scheme=scheme,
                                        topk_frac=0.25)
        out[scheme] = got.numpy().tolist()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)


def seq_decode_rank(rank, world, mesh, kv_shard, inputs_path, out_dir,
                    positions):
    """The rank's rows and stripe of the saved inputs through
    ``seq_decode_attention`` at every position (each from the saved
    cache); saves the outputs and the stripes after each write."""
    from repro_torch.dist.seq_decode import seq_decode_attention
    from repro_torch.dist.sharding import ShardingConfig

    x = torch.load(inputs_path)
    rules = ShardingConfig(data_axes=("data",), model_axes=("model",),
                           kv_shard=kv_shard).rules(mesh)
    seq, bax = rules.axes("kv_seq"), rules.axes("batch")
    b, s = x["ck"].shape[:2]
    bl, sl = b // mesh.axes_size(bax), s // mesh.axes_size(seq)
    b0, s0 = mesh.index(bax) * bl, mesh.index(seq) * sl
    rows = slice(b0, b0 + bl)
    out = {"b0": b0, "s0": s0, "runs": {}}
    for pos in positions:
        ck = x["ck"][rows, s0:s0 + sl].clone()
        cv = x["cv"][rows, s0:s0 + sl].clone()
        o, ck, cv = seq_decode_attention(
            x["q"][rows], x["kn"][rows], x["vn"][rows], ck, cv, pos,
            mesh=mesh, seq_axes=seq, batch_axes=bax)
        out["runs"][pos] = {"out": o, "ck": ck, "cv": cv}
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


COLLECTIVE_AXES = (("data",), ("model",), ("data", "model"))
COLLECTIVE_ROUTES = ("allreduce", "native")
LEAF_SPECS = ((("data", "model"), None), (None, "model"), ("data", "model"),
              ("model", "data"))


def collectives_rank(rank, world, mesh, inputs_path, out_dir):
    """Each differentiable collective on this rank's row of the saved
    inputs along every axes of ``COLLECTIVE_AXES``, with the all-reduce
    construction and the native ops (``ROUTE``): its result, the
    gradient of ``<w, out>`` (w this rank's saved cotangent) and the
    counters of the call; then ``shard_leaf``/``unshard_leaf`` of a saved
    leaf under each of ``LEAF_SPECS``."""
    from repro_torch.dist import collectives as c
    from repro_torch.dist.sharding import shard_leaf, unshard_leaf

    x_all = torch.load(inputs_path)
    out = {}
    for route in COLLECTIVE_ROUTES:
        c.ROUTE[0] = route
        for axes in COLLECTIVE_AXES:
            for op in ("all_reduce", "all_gather", "reduce_scatter",
                       "all_max"):
                x = x_all["x"][rank].clone().requires_grad_(op != "all_max")
                c.COUNTERS.reset()
                if op in ("all_gather", "reduce_scatter"):
                    y = getattr(c, op)(x, mesh, axes, 1)
                else:
                    y = getattr(c, op)(x, mesh, axes)
                counts = c.COUNTERS.snapshot()
                grad = None
                if op != "all_max":
                    # the saved cotangent cut to the output's width
                    w = x_all["w_" + op][rank][:, :y.shape[1]]
                    (y * w).sum().backward()
                    grad = x.grad
                out[(route, axes, op)] = {"y": y.detach(), "grad": grad,
                                          "counts": counts}
        c.ROUTE[0] = None
    for spec in LEAF_SPECS:
        block = shard_leaf(x_all["leaf"], spec, mesh)
        out[("leaf", spec)] = {"block": block,
                               "whole": unshard_leaf(block, spec, mesh)}
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def serve_rank(rank, world, mesh, cfg, kw, out_dir):
    """``serve_session`` of ``cfg`` on the CPU under ``kv_shard="seq"``,
    counting the decode steps' calls of ``seq_decode_attention``."""
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.serve import serve_session

    from repro_torch.dist import seq_decode

    scfg = ShardingConfig(data_axes=("data",), model_axes=(),
                          kv_shard="seq")
    calls = [0]
    real = seq_decode.seq_decode_attention

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    seq_decode.seq_decode_attention = counted
    try:
        out = serve_session(cfg, scfg=scfg, mesh=mesh, device="cpu",
                            return_logits=True, **kw)
    finally:
        seq_decode.seq_decode_attention = real
    torch.save({"generated": out["generated"], "logits": out["logits"],
                "seq_decode_calls": calls[0]},
               Path(out_dir) / f"rank{rank}.pt")


def stripe_rank(rank, world, mesh, cfg, out_dir):
    """``LM.prefill`` of 10 tokens under ``kv_shard="seq"`` rules with
    ``max_len`` 16: each rank keeps its stripe of 8 positions."""
    from repro_torch.dist.api import use_rules
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.models import build_model

    model = build_model(cfg, seed=0, device="cpu").cast_for_serving()
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 10)))
    rules = ShardingConfig(data_axes=("data",), model_axes=(),
                           kv_shard="seq").rules(mesh)
    with use_rules(rules):
        _, state = model.prefill(tokens, max_len=16)
    torch.save({"caches": [{"k": c["k"], "v": c["v"]} for c in state],
                "s0": [c["stripe"].s0 for c in state]},
               Path(out_dir) / f"rank{rank}.pt")


def tp_serve_rank(rank, world, mesh, jobs, out_dir):
    """For each job ``(tag, cfg, kw, scfg_kw, weights_path)``,
    ``serve_session`` of the saved weights under
    ``ShardingConfig(**scfg_kw)``: saves (as ``<tag>_rank<r>.pt``) its
    tokens and logits, each rank's resident blocks' shapes and the
    session's collectives' counters."""
    from repro_torch.dist.collectives import COUNTERS
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.serve import serve_session

    for tag, cfg, kw, scfg_kw, weights_path in jobs:
        model = _model_from(cfg, weights_path).cast_for_serving()
        COUNTERS.reset()
        out = serve_session(cfg, scfg=ShardingConfig(**scfg_kw), mesh=mesh,
                            model=model, device="cpu", return_logits=True,
                            **kw)
        torch.save({"generated": out["generated"], "logits": out["logits"],
                    "counts": COUNTERS.snapshot(),
                    "shapes": {n: tuple(p.shape)
                               for n, p in model.named_parameters()}},
                   Path(out_dir) / f"{tag}_rank{rank}.pt")


def train_rank(rank, world, mesh, cfg, kw, scfg_kw, out_dir,
               weights_path=None):
    """``train_loop`` of ``cfg`` on the CPU over the mesh's ranks (from
    the saved weights where given, else from the seed)."""
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.train import train_loop

    scfg = ShardingConfig(**scfg_kw)
    if weights_path is not None:
        kw = dict(kw, model=_model_from(cfg, weights_path))
    out = train_loop(cfg, scfg=scfg, mesh=mesh, device="cpu", log_every=0,
                     **kw)
    params = {k: v.detach().clone() for k, v in
              out["state"]["params"].items()}
    torch.save({"losses": out["losses"], "resumed_from": out["resumed_from"],
                "params": params}, Path(out_dir) / f"rank{rank}.pt")


def _model_from(cfg, weights_path):
    """``cfg``'s model on the CPU holding the saved ``state_dict``."""
    from repro_torch.models import build_model

    model = build_model(cfg, seed=0, device="cpu")
    model.load_state_dict(torch.load(weights_path))
    return model


def grads_rank(rank, world, mesh, jobs, out_dir):
    """For each job ``(tag, cfg, scfg_kw, weights_path, batch_path)``, one
    ``loss_and_grads`` of the saved weights on this rank's rows of the
    saved batch under ``ShardingConfig(**scfg_kw)``: saves (as
    ``<tag>_rank<r>.pt``) each stored block, the loss, the collectives'
    counters of the step and each gradient gathered whole."""
    from repro_torch.dist.collectives import COUNTERS
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.steps import loss_and_grads, rank_rows

    for tag, cfg, scfg_kw, weights_path, batch_path in jobs:
        scfg = ShardingConfig(**scfg_kw)
        model = _model_from(cfg, weights_path)
        layout = model.shard(scfg.rules(mesh), "storage", scfg)
        blocks = {n: p.detach().clone() for n, p in model.named_parameters()}
        batch = rank_rows(torch.load(batch_path), mesh, scfg,
                          scfg.microbatches)
        COUNTERS.reset()
        loss, grads, _ = loss_and_grads(model, batch,
                                        microbatches=scfg.microbatches,
                                        remat=scfg.remat, mesh=mesh,
                                        batch_axes=scfg.batch_axes(mesh))
        counts = COUNTERS.snapshot()
        whole = {n: layout.unshard(n, g) for n, g in grads.items()}
        torch.save({"loss": float(loss), "blocks": blocks, "counts": counts,
                    "grads": whole if rank == 0 else None},
                   Path(out_dir) / f"{tag}_rank{rank}.pt")


def many_rank(rank, world, mesh, parts, out_dir):
    """Each ``(fn, jobs)`` of ``parts`` in turn, ``fn(rank, world, mesh,
    jobs, out_dir)``: every case of a mesh shape in one spawn."""
    for fn, jobs in parts:
        fn(rank, world, mesh, jobs, out_dir)


def compress_step_rank(rank, world, mesh, jobs, out_dir):
    """For each job ``(tag, cfg, scfg_kw, weights_path, batch_path,
    opt_kw)``, one ``train_step`` of the saved weights, sharded under
    ``ShardingConfig(**scfg_kw)`` (its ``grad_compression``), on this
    rank's rows of the saved batch with ``AdamWConfig(**opt_kw)``: saves
    the parameters and the error-feedback residual after it, gathered
    whole (rank 0)."""
    from repro_torch.dist.compression import init_error_state
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.steps import rank_rows, train_step
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    for tag, cfg, scfg_kw, weights_path, batch_path, opt_kw in jobs:
        scfg = ShardingConfig(**scfg_kw)
        model = _model_from(cfg, weights_path)
        layout = model.shard(scfg.rules(mesh), "storage", scfg)
        params = dict(model.named_parameters())
        err = init_error_state(params)
        opt_cfg = AdamWConfig(**opt_kw)
        opt = init_opt_state(params, opt_cfg, layout.moment_grids())
        batch = rank_rows(torch.load(batch_path), mesh, scfg)
        out = train_step(model, opt, batch, opt_cfg,
                         grad_compression=scfg.grad_compression, err=err)
        whole = {"params": {n: layout.unshard(n, p.detach())
                            for n, p in params.items()},
                 "err": {n: layout.unshard(n, e) for n, e in err.items()}}
        torch.save({"loss": float(out["loss"]),
                    **(whole if rank == 0 else {})},
                   Path(out_dir) / f"{tag}_rank{rank}.pt")


def moments_rank(rank, world, mesh, jobs, out_dir):
    """For each job ``(tag, cfg, scfg_kw, weights_path, grads_path,
    opt_kw)``, the saved weights sharded under
    ``ShardingConfig(**scfg_kw)`` take one AdamW step with int8 moments
    (``AdamWConfig(**opt_kw)``) for each saved whole gradient, each rank
    on its blocks: saves (rank 0) the parameters and the moments gathered
    whole, and whether every moment's ``shard_moment(unshard_moment(m))``
    is ``m``."""
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                         init_opt_state)

    for tag, cfg, scfg_kw, weights_path, grads_path, opt_kw in jobs:
        scfg = ShardingConfig(**scfg_kw)
        model = _model_from(cfg, weights_path)
        layout = model.shard(scfg.rules(mesh), "storage", scfg)
        params = dict(model.named_parameters())
        opt_cfg = AdamWConfig(**opt_kw)
        opt = init_opt_state(params, opt_cfg, layout.moment_grids())
        for grads in torch.load(grads_path):
            apply_updates(params, {n: layout.block(n, g)
                                   for n, g in grads.items()}, opt, opt_cfg,
                          decay_mask=model.decay_mask(),
                          norm=layout.global_norm,
                          grids=layout.moment_grids())
        whole = {part: {n: layout.unshard_moment(n, m)
                        for n, m in opt[part].items()} for part in "mv"}
        round_trip = all(
            all(torch.equal(layout.shard_moment(n, whole[part][n])[k], v)
                for k, v in m.items())
            for part in "mv" for n, m in opt[part].items())
        params = {n: layout.unshard(n, p.detach())
                  for n, p in params.items()}
        torch.save({"round_trip": round_trip,
                    "grids": sorted(layout.moment_grids()),
                    **({"params": params, "opt": whole} if rank == 0
                       else {})},
                   Path(out_dir) / f"{tag}_rank{rank}.pt")


def step_counts_rank(rank, world, mesh, jobs, out_dir):
    """For each job ``(tag, kind, cfg, scfg_kw, kw)`` one step from the
    builder of ``launch.steps`` (``kind`` ``"train"``: ``make_train_step``
    on ``kw["batch"]`` seeded rows of ``kw["seq_len"]`` tokens;
    ``"serve"``: ``make_serve_step`` of ``kw["batch"]`` rows against caches
    of ``kw["max_len"]``, at its last position), run on real CPU tensors
    (the model from seed 0) with the native collective route: saves (as
    ``<tag>_rank<r>.pt``) the step's collective counters."""
    from repro_torch.dist import collectives
    from repro_torch.dist.api import use_rules
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch import steps
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state

    collectives.ROUTE[0] = "native"
    for tag, kind, cfg, scfg_kw, kw in jobs:
        scfg = ShardingConfig(**scfg_kw)
        model = build_model(cfg, seed=0, device="cpu")
        if kind == "train":
            batch = step_batch(cfg, kw["batch"], kw["seq_len"])
            bundle = steps.make_train_step(
                cfg, scfg, mesh, AdamWConfig(),
                {k: v.to("meta") for k, v in batch.items()})
            layout = model.shard(scfg.rules(mesh), "storage", scfg)
            params = dict(model.named_parameters())
            opt = init_opt_state(params, AdamWConfig(),
                                 layout and layout.moment_grids())
            args = (model, opt, steps.rank_rows(batch, mesh, scfg,
                                                scfg.microbatches), None)
        else:
            bundle = steps.make_serve_step(cfg, scfg, mesh, kw["batch"],
                                           kw["max_len"])
            model.cast_for_serving()
            rules = steps.shard_for_serving(model, scfg, mesh)
            rows = bundle.in_specs[2].shape[0]
            with use_rules(rules):
                state = model.init_decode_state(rows, kw["max_len"])
            tokens = torch.ones((rows, 1), dtype=torch.int32)
            args = (model, state, tokens, kw["max_len"] - 1)
        collectives.COUNTERS.reset()
        bundle.run(*args)
        torch.save({"counts": collectives.COUNTERS.snapshot()},
                   Path(out_dir) / f"{tag}_rank{rank}.pt")


def mesh_subset_rank(rank, world, mesh, cfg, run, scfg_kw, serve_kw,
                     out_dir):
    """On the group's mesh: ``run`` uninterrupted to 12 steps, then 8
    steps checkpointed at 4 and 8; then ``make_host_mesh(1)`` on every
    rank, the run resumed to 12 on it, and ``serve_session`` on it; then
    ``make_host_mesh(world + 1)``, which must raise."""
    from repro_torch.dist.sharding import ShardingConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import serve_session
    from repro_torch.launch.train import train_loop

    scfg = ShardingConfig(**scfg_kw)
    kw = dict(run, scfg=scfg, device="cpu", log_every=0)
    ckpt = str(Path(out_dir) / "ckpt")
    whole = train_loop(cfg, steps_total=12, mesh=mesh, **kw)
    first = train_loop(cfg, steps_total=8, mesh=mesh, ckpt_dir=ckpt,
                       ckpt_every=4, **kw)
    sub = make_host_mesh(1, device="cpu")
    t0 = time.perf_counter()
    resumed = train_loop(cfg, steps_total=12, mesh=sub, ckpt_dir=ckpt,
                         ckpt_every=100, **kw)
    resumed_s = time.perf_counter() - t0
    served = serve_session(cfg, mesh=sub, device="cpu", **serve_kw)
    try:
        make_host_mesh(world + 1, device="cpu")
        too_large = None
    except ValueError as e:
        too_large = str(e)
    torch.save({"whole": whole["losses"], "first": first["losses"],
                "member": sub.member, "sub_size": sub.size,
                "resumed": {k: resumed[k] for k in ("losses", "resumed_from",
                                                    "final_loss")},
                "resumed_state": resumed["state"] is not None,
                "resumed_s": resumed_s,
                "generated": served["generated"], "too_large": too_large},
               Path(out_dir) / f"rank{rank}.pt")


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def elastic_rank(rank, world, mesh, out_dir):
    """``examples/torch_elastic_restart.py`` on the CPU on this group's
    ranks, then (the run it is held to) the same training uninterrupted on
    every rank to step 16, checkpointed at 12 (whose parameters phase 1
    must end with)."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.launch.train import train_loop

    example = load_example("torch_elastic_restart")
    out = example.main(["--device", "cpu"])
    ckpt = Path(out_dir) / "whole"
    whole = train_loop(example.smoke_cfg(), steps_total=16,
                       ckpt_dir=str(ckpt), ckpt_every=12,
                       mesh=mesh, scfg=example.sharding(world),
                       device="cpu", **example.RUN)
    got = {}
    if rank == 0:
        want = CheckpointManager(ckpt).restore(step=12, device="cpu")[1]
        phase1 = CheckpointManager(out["ckpt_dir"]).restore(
            step=12, device="cpu")[1]
        got = {"want12": want["params"], "phase1_12": phase1["params"]}
    report, shrunk = out["phase1"], out["phase2"]
    torch.save({"attempts": report.attempts,
                "resumed_from": report.result["resumed_from"],
                "phase2": None if shrunk is None else {
                    k: shrunk[k] for k in ("losses", "resumed_from")},
                "whole": whole["losses"], **got},
               Path(out_dir) / f"rank{rank}.pt")


def step_batch(cfg, batch: int, seq_len: int) -> dict:
    """A seeded global batch of ``batch`` rows of ``seq_len`` tokens
    (int32, as ``launch.shapes.batch_specs_for`` gives them)."""
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (batch, seq_len + 1))
    return {"tokens": torch.as_tensor(toks[:, :-1], dtype=torch.int32),
            "labels": torch.as_tensor(toks[:, 1:], dtype=torch.int32)}


def load_ranks(out_dir: Path, world: int, tag: str = "") -> list:
    prefix = f"{tag}_" if tag else ""
    return [torch.load(Path(out_dir) / f"{prefix}rank{r}.pt",
                       weights_only=False) for r in range(world)]


def float32(cfg):
    return dataclasses.replace(cfg, compute_dtype="float32")


__all__ = ["COLLECTIVE_AXES", "COLLECTIVE_ROUTES", "LEAF_SPECS",
           "allreduce_rank", "collectives_rank", "compress_step_rank",
           "elastic_rank", "float32", "grads_rank", "load_example",
           "load_ranks", "many_rank", "mesh_subset_rank", "moments_rank", "run_ranks", "seq_decode_rank", "serve_rank",
           "step_batch", "step_counts_rank", "stripe_rank", "tp_serve_rank",
           "train_rank"]
