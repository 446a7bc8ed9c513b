"""Training entry point: data pipeline -> train step -> checkpoint/restart.

    python -m repro_torch.launch.train --arch qwen2.5-3b          # the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \
        --smoke --steps 3 --device cpu

The port of the reference's ``launch/train.py`` on one card, for every
family: the decoder-only ones (dense, MoE, RWKV-6, Jamba, the VLM with its
patch embeddings) and the encoder-decoder (frame embeddings into the
encoder, tokens of ``decoder_len`` into the decoder).  Fault
tolerance is the reference's: checkpoints every ``ckpt_every`` steps
(async, atomic), auto-resume from the latest complete checkpoint, and a
data pipeline that regenerates its stream from the step counter, so a run
restarted by ``dist.run_with_restarts`` ends bitwise where an uninterrupted
one does (on the card, with ``torch.use_deterministic_algorithms(True)``).
``remat`` and ``microbatches`` are the reference's ``ShardingConfig``
fields.  Logging goes through ``logging``.

Data parallelism (``scfg=``, ``mesh=`` a mesh of ranks,
``launch.mesh.make_host_mesh``): every rank builds the same model from
the seed, and rank 0's parameters are broadcast once so no rank can
drift; each step every rank regenerates the step's global batch and
takes the rows of its coordinate along the batch axes (``batch_specs``),
and ``train_step`` reduces the loss and gradients to the global mean
(optionally compressed with error feedback, the residual checkpointed
with the state).  Only rank 0 writes checkpoints; the others wait at a
barrier until each is complete.

Tensor, expert and FSDP parameter sharding (the rules map model, expert
or FSDP axes of more than one rank), for every family and every layout
``ShardingConfig`` derives: after the broadcast every rank keeps its
``param_specs`` block of each parameter and frees the rest
(``LM.shard``/``EncDec.shard``), and its AdamW moments and its
error-feedback residual are blocks of the same layout (an int8 moment of
a leaf cut along its last axis on the whole leaf's quantization grid).
Checkpoints stay layout-free: every rank joins the gathers of each leaf
and rank 0 writes the whole leaves, and a resume slices the whole leaves
into the new mesh's blocks, so a run resumes from a checkpoint written by
a different number of ranks.  Under ``torchrun`` the CLI joins the group
the environment names:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \
        --arch qwen2.5-3b --smoke --device cpu
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-moe-a2.7b --smoke --device cpu --mesh 2,2 \
        --model-axes model --fsdp-axes data --expert-axes model
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .. import configs, resolve_device
from ..ckpt.manager import CheckpointManager
from ..data.pipeline import DataConfig, SyntheticPipeline
from ..dist.compression import init_error_state
from ..dist.sharding import ShardingConfig
from ..models import LM, EncDec, build_model
from ..optim.adamw import AdamWConfig, init_opt_state
from ..optim.schedule import warmup_cosine
from .mesh import add_mesh_args, axes_arg, mesh_from_args
from .steps import rank_rows, train_step

__all__ = ["main", "make_data_cfg", "train_loop"]

log = logging.getLogger("repro_torch.train")


def make_data_cfg(cfg, batch: int, seq_len: int, seed: int = 0) -> DataConfig:
    return DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq_len, global_batch=batch,
        seed=seed, frontend=cfg.frontend, d_model=cfg.d_model,
        n_patches=cfg.n_patches, decoder_len=cfg.decoder_len)


def _restore(mgr: CheckpointManager, model: LM | EncDec,
             opt_cfg: AdamWConfig, dev: torch.device
             ) -> tuple[int, dict, dict | None]:
    """Load the latest checkpoint into ``model``; returns (step, opt
    state, error-feedback state or None).  Raises ``ValueError``/
    ``KeyError`` when it does not fit."""
    step, state, _ = mgr.restore(device=dev)
    params = dict(model.named_parameters())
    saved = state["params"]
    if set(saved) != set(params):
        raise KeyError(f"checkpoint holds {len(saved)} parameters, the "
                       f"model {len(params)}")
    for name, p in params.items():
        if saved[name].shape != p.shape or saved[name].dtype != p.dtype:
            raise ValueError(f"{name}: checkpoint {tuple(saved[name].shape)} "
                             f"{saved[name].dtype}, model {tuple(p.shape)} "
                             f"{p.dtype}")
    fresh = init_opt_state(params, opt_cfg)
    for part in ("m", "v"):
        if set(state["opt"][part]) != set(fresh[part]) or any(
                isinstance(state["opt"][part][n], dict)
                != isinstance(fresh[part][n], dict) for n in params):
            raise ValueError(f"checkpoint's optimizer {part!r} does not fit "
                             f"moments_dtype={opt_cfg.moments_dtype!r}")
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(saved[name])
    opt = state["opt"]
    opt["count"] = opt["count"].cpu()
    return step, opt, state.get("err")


def train_loop(cfg, *, steps_total: int, batch: int, seq_len: int,
               ckpt_dir: str | Path | None = None, ckpt_every: int = 50,
               scfg: ShardingConfig | None = None,
               opt_cfg: AdamWConfig | None = None, mesh=None,
               log_every: int = 10, seed: int = 0,
               fail_at_step: int | None = None,
               remat: bool | str | None = None,
               microbatches: int | None = None,
               model: LM | EncDec | None = None, device=None) -> dict:
    """Train ``cfg`` for ``steps_total`` steps; returns ``{"losses",
    "resumed_from", "final_loss", "state", "step_seconds"}``.

    ``model`` carries weights in (its device is used); otherwise one is
    built from ``seed`` on ``device`` (``None`` = the card).  ``state`` is
    ``{"params": {name: tensor}, "opt": ..., "step": int32}`` (and
    ``"err"``, the error-feedback residual, under ``grad_compression``),
    the parameters being the model's own (each rank's blocks, where the
    layout shards them).  ``step_seconds`` is each step's
    host-clock time, which ends with reading its loss (a synchronize);
    ``allreduce_seconds`` the host-clock time of each step's gradient
    all-reduce (a synchronize before and after it) on a mesh of several
    ranks.  ``remat``/``microbatches`` default to ``scfg``'s (else off /
    1).  ``mesh`` is a mesh of ranks (``make_host_mesh``); ``scfg``
    defaults to data parallelism over its first axis.  On a rank outside
    the mesh (``mesh.member`` False) it returns at once, with no loss and
    ``state`` ``None``, and joins no collective.
    """
    if mesh is not None and not mesh.member:
        return {"losses": [], "resumed_from": None, "final_loss": None,
                "state": None, "step_seconds": [], "allreduce_seconds": []}
    if scfg is None:
        scfg = ShardingConfig(
            data_axes=mesh.axis_names[:1] if mesh is not None else
            ("data",), model_axes=(), fsdp_axes=(), microbatches=1,
            remat=False)
    remat = scfg.remat if remat is None else remat
    microbatches = microbatches or scfg.microbatches
    opt_cfg = opt_cfg or AdamWConfig(
        learning_rate=warmup_cosine(3e-4, 20, steps_total))
    if model is None:
        model = build_model(cfg, seed=seed, device=resolve_device(device))
    elif device is not None \
            and torch.device(device).type != model.device.type:
        raise ValueError(f"model lies on {model.device}, device={device!r}")
    batch_axes: tuple = ()
    rank, over_ranks = 0, mesh is not None and mesh.size > 1
    if mesh is not None:
        batch_axes = scfg.batch_axes(mesh)
        rank = mesh.rank
    dev = model.device
    # every rank regenerates the global batch of a step (a pure function
    # of seed and step) and keeps its rows, so 1 rank and n ranks see the
    # same data and a resume on another rank count continues it
    data = SyntheticPipeline(make_data_cfg(cfg, batch, seq_len, seed))
    params = dict(model.named_parameters())

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step, resumed_from, opt, err = 0, None, None, None
    if mgr and mgr.latest_step() is not None:
        try:
            start_step, opt, err = _restore(mgr, model, opt_cfg, dev)
            resumed_from = start_step
        except (KeyError, ValueError) as e:
            log.warning(f"WARNING: checkpoint in {ckpt_dir} is incompatible "
                        f"with this model ({type(e).__name__}: {e}); "
                        "starting fresh")
    layout = getattr(model, "layout", None)
    if over_ranks and layout is None:
        # one broadcast from the mesh's rank 0, so no rank's parameters
        # can drift
        group = mesh.all_group()
        with torch.no_grad():
            for p in params.values():
                dist.broadcast(p.data, src=dist.get_global_rank(group, 0),
                               group=group)
        # then each rank keeps its blocks (and its moments' and residual's)
        layout = model.shard(scfg.rules(mesh), "storage", scfg)
        if layout is not None and opt is not None:
            opt = {"m": {n: layout.shard_moment(n, m)
                         for n, m in opt["m"].items()},
                   "v": {n: layout.shard_moment(n, v)
                         for n, v in opt["v"].items()},
                   "count": opt["count"]}
        if layout is not None and err is not None and set(err) == set(
                params):
            err = {n: layout.block(n, e) for n, e in err.items()}
    if opt is None:
        opt = init_opt_state(params, opt_cfg, None if layout is None
                             else layout.moment_grids())
    compress = scfg.grad_compression
    if compress == "none":
        err = None
    elif err is None or set(err) != set(params):
        err = init_error_state(params)
    writer = mgr if rank == 0 else None

    def state(step: int) -> dict:
        out = {"params": params, "opt": opt,
               "step": torch.tensor(step, dtype=torch.int32)}
        if err is not None:
            out["err"] = err
        return out

    def whole(step: int) -> dict:
        """The state with whole leaves: every rank joins the gathers."""
        if layout is None:
            return state(step)
        out = {"params": {n: layout.unshard(n, p.detach())
                          for n, p in params.items()},
               "opt": {"m": {n: layout.unshard_moment(n, m)
                             for n, m in opt["m"].items()},
                       "v": {n: layout.unshard_moment(n, v)
                             for n, v in opt["v"].items()},
                       "count": opt["count"]},
               "step": torch.tensor(step, dtype=torch.int32)}
        if err is not None:
            out["err"] = {n: layout.unshard(n, e) for n, e in err.items()}
        return out

    def save(step: int, extra: dict) -> None:
        full = whole(step)
        if writer:
            writer.save(step, full, extra=extra)
        del full
        if over_ranks:
            if writer:
                writer.wait()            # complete before anyone reads it
            dist.barrier(group=mesh.all_group())

    losses: list[float] = []
    step_seconds: list[float] = []
    allreduce_seconds: list[float] = []
    t0 = time.time()
    try:
        for step, host_batch in data.iterate(start_step):
            if step >= steps_total:
                break
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t_step = time.perf_counter()
            if mesh is not None:
                host_batch = rank_rows(host_batch, mesh, scfg,
                                       microbatches)
            dev_batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in host_batch.items()}
            metrics = train_step(model, opt, dev_batch, opt_cfg,
                                 microbatches=microbatches, remat=remat,
                                 grad_compression=compress, err=err,
                                 mesh=mesh, batch_axes=batch_axes)
            if "allreduce_s" in metrics:
                allreduce_seconds.append(metrics["allreduce_s"])
            loss = float(metrics["loss"])
            step_seconds.append(time.perf_counter() - t_step)
            losses.append(loss)
            if log_every and step % log_every == 0:
                log.info(f"step {step:5d}  loss {loss:7.4f}  "
                         f"gnorm {float(metrics['gnorm']):7.3f}  "
                         f"{time.time() - t0:6.1f}s")
            if mgr and ckpt_every and (step + 1) % ckpt_every == 0:
                save(step + 1, {"loss": loss})
    except BaseException:
        # flush in-flight async saves so a supervised restart
        # (dist.run_with_restarts) sees every completed checkpoint —
        # otherwise resume races the writer thread
        if writer:
            writer.wait()
        raise
    final = state(max(steps_total, start_step))
    if mgr:
        save(steps_total, {"final": True})
        if writer:
            writer.wait()
    return {"losses": losses, "resumed_from": resumed_from,
            "final_loss": losses[-1] if losses else None, "state": final,
            "step_seconds": step_seconds,
            "allreduce_seconds": allreduce_seconds}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8", "topk"],
                    help="error-feedback gradient compression")
    add_mesh_args(ap)
    ap.add_argument("--fsdp-axes", default="",
                    help="mesh axes sharding the parameters (FSDP), e.g. "
                    "'data'")
    ap.add_argument("--expert-axes", default="",
                    help="mesh axes sharding the experts, e.g. 'model'")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    # under torchrun: a mesh of every rank of the group, (n,) over "data"
    # (data parallelism) unless --mesh gives its shape over (data, model)
    mesh = mesh_from_args(args, dev)
    scfg = ShardingConfig(data_axes=("data",),
                          model_axes=axes_arg(args.model_axes),
                          fsdp_axes=axes_arg(args.fsdp_axes),
                          expert_axes=axes_arg(args.expert_axes),
                          grad_compression=args.grad_compression)
    out = train_loop(cfg, steps_total=args.steps, batch=args.batch,
                     seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, seed=args.seed, device=dev,
                     scfg=scfg, mesh=mesh)
    ranks = ("" if mesh is None else
             f" on rank {mesh.rank} of {mesh.size}")
    log.info(f"final loss: {out['final_loss']:.4f} "
             f"(first: {out['losses'][0]:.4f}) on {dev}{ranks}")
    if mesh is not None:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
