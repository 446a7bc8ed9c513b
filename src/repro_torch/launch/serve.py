"""Serving entry point: batched prefill, then a decode loop with KV caches.

    python -m repro_torch.launch.serve --arch qwen2.5-3b          # the card
    python -m repro_torch.launch.serve --arch qwen2.5-3b --smoke --device cpu

A random prompt batch (``numpy.random.default_rng(seed)``, as in the
reference) is prefilled through the flash-attention kernel, then ``gen``
tokens are decoded greedily through the split-KV decode kernel.  The
weights are random, drawn from ``--seed`` on the device, and cast to
``compute_dtype`` once when the model is built.

``--tuned-kernels STORE`` enables the kernel-autotuning fast path: both
attention kernels resolve their cached best launch parameters
(``repro_torch.tune.kernels.tune_kernel``) for each call's shape, with zero
measurements at serve time and the defaults on a miss.

``--stream`` switches to the online runtime: batches flow through
``repro_torch.runtime.StreamingPipeline``, each chunk-scheduled across
device groups, and the EWMA controller adapts the split as they run.
``--stream-workload lm`` (the default, as in the reference) serves
request batches (prefill + greedy decode per group; ``--slow N`` reserves
the last N devices as a second group).  ``--stream-workload dna`` streams
the paper's motif count: ``--batch`` rows of ``--row-len`` DNA symbols a
batch, from (pinned) host memory, split between a ``host`` group (the
plain DFA on CPU threads) and the device group (the state-map and count
kernels on the card, or a second CPU group with ``--device cpu``).

    python -m repro_torch.launch.serve --stream --stream-workload dna \
        --device cpu --batch 8 --row-len 4096 --tune-split

``--tune-split`` tunes the initial split first: the reference's
nine-fraction space with ``--tune-strategy`` (``sam``) for ``lm``, the
paper's host space (``split_space``: host threads x host affinity x host
fraction, SAML within 5 % measured) for ``dna``; ``--tune-store`` caches
the winner per workload.  ``--guard`` adds the kill-switch guardrail.
A group that fails in a tune's step stops the tune; one that fails in
the stream (outside a ``--fault-plan`` drill) ends the run with a
non-zero exit once every row is served by the survivors.

Observability (``repro_torch.obs``): ``--trace-out`` / ``--journal-out`` /
``--metrics-out`` record a ``--stream`` run — a Chrome-loadable span
trace, the decision journal (JSONL), and an ``obs_summary.json``.
``--fault-plan "kill:0@3,slow:1@9:4"`` replays a scripted failure drill
against simulated serial-device groups on a ``VirtualClock`` (no model
build, deterministic timestamps); ``python -m repro_torch.obs`` checks its
artifacts against ``docs/obs_schema.json``.

``--serve-requests N`` switches to the request-level serving engine
(``repro_torch.serve``): N requests from a deterministic arrival source
(``--request-rate`` requests/s, ``--serve-seed``) flow through SLO-aware
admission and the continuous batcher into the chunked scheduler, with
per-request completion records.  With ``--sim-serve`` or ``--fault-plan``
the engine runs the deterministic sim rig (``VirtualClock``, no model
build); otherwise the arch's model serves each formed batch (prefill and
greedy decode) on ``--device``, the card by default.  ``--tune-batcher``
tunes the batcher knobs on the sim rig through ``TuningSession`` first
(persisted in ``--batcher-store``).

    python -m repro_torch.launch.serve --serve-requests 200 --sim-serve

Crash durability (``runtime.checkpoint``; sim rig only): ``--wal PATH``
appends every admit/retire/step to a write-ahead request log and
``--snapshot PATH`` checkpoints the engine's soft state; after a crash
(scripted with ``--fault-plan 'crash:0@N'`` or ``'torn:0@N'``, raising
and exiting with code 17, or a real ``SIGKILL`` with ``--crash-sigkill``)
the same command plus ``--resume`` replays the unretired requests and
finishes the run with every admitted request accounted;
``python -m repro_torch.obs --wal PATH --wal-complete`` checks the log.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import configs, resolve_device
from ..core.hetero import DeviceGroup
from ..core.space import ConfigSpace, Param
from ..dist.api import use_rules
from ..dist.sharding import ShardingConfig
from ..models import LM, EncDec, build_model
from ..obs import get_logger
from .mesh import add_mesh_args, axes_arg, make_host_mesh, mesh_from_args
from .steps import serving_rules, shard_for_serving

__all__ = ["HOST_FRACTIONS", "dna_stream_batches", "main", "serve_requests",
           "serve_session", "serve_stream", "split_space",
           "tune_stream_split"]

log = logging.getLogger("repro_torch.serve")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _checksum_agrees(model, mesh) -> bool:
    """Whether every rank holds the same parameter blocks as the other
    ranks that hold the same blocks: per set of such ranks, the largest
    of a float64 checksum and of its negation over them (their max and
    min) must agree (a broadcast of GBs of weights would cost seconds).
    A leaf split over ranks (``model.layout``) is compared along the axes
    its compute does not split (its storage, where the rank stores
    blocks), every other leaf over all ranks."""
    layout = getattr(model, "layout", None)
    split = () if layout is None else tuple(
        a for a in mesh.axis_names
        if a in layout.rules.axes("heads") + layout.rules.axes("expert"))
    sums: dict[tuple, torch.Tensor] = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        if layout is not None and layout.resident == "storage":
            held = layout.leaves[name].storage_axes
            axes = tuple(a for a in mesh.axis_names if a not in held)
        else:
            whole = layout is None \
                or tuple(p.shape) == layout.leaves[name].shape
            axes = tuple(a for a in mesh.axis_names
                         if whole or a not in split)
        c = sums.setdefault(axes, torch.zeros(2, dtype=torch.float64,
                                              device=model.device))
        c[0] += p.detach().sum(dtype=torch.float64) * (1 + i % 7)
    agree = True
    for axes, c in sums.items():
        if mesh.axes_size(axes) > 1:
            c[1] = -c[0]
            dist.all_reduce(c, op=dist.ReduceOp.MAX, group=mesh.group(axes))
            agree &= bool(c[0] == -c[1])
    return agree


@torch.inference_mode()
def serve_session(cfg, *, batch: int, prompt_len: int, gen: int,
                  scfg: ShardingConfig | None = None, mesh=None,
                  seed: int = 0, greedy: bool = True,
                  model: LM | EncDec | None = None, device=None,
                  return_logits: bool = False) -> dict:
    """Prefill a random prompt batch, then decode ``gen`` tokens.

    An encoder-decoder (``cfg.encdec``) encodes ``prompt_len`` random
    frames instead (drawn after the tokens from the same generator, as the
    reference draws them), fills its cross-attention caches, and decodes
    from position 0 starting with token 0; a VLM is served on its text
    alone, as the reference's ``serve_session`` serves it.

    ``model`` takes an already-built model (its device is used); otherwise
    one is built from ``seed`` on ``device`` (``None`` = the card) and cast
    for serving.  Times are host clock readings taken after a device
    synchronize, so they cover the device's work.  Runs under
    ``torch.inference_mode()``: the parameters require grad, and nothing
    here needs a graph.

    With a ``mesh`` of ranks (``launch.mesh.make_host_mesh``) every rank
    builds the model from ``seed`` and draws the same prompt.  Where the
    rules split the heads, ``ff`` columns, vocabulary or experts over
    ranks, each rank keeps its compute blocks of them (``LM.shard(...,
    "compute")``): its q heads and the kv heads they read, which its
    cache holds under ``kv_shard="heads"`` (all kv heads under
    ``"none"``), and the logits are gathered whole before the token is
    picked.  Where ``scfg.fsdp_axes`` lie on the mesh each rank stores
    its ``param_specs`` block of every leaf instead and gathers each
    layer's compute blocks where the layer runs (``LM.shard(...,
    "storage")``; ``launch.steps.shard_for_serving``), forward only.
    Each rank's blocks must agree (a checksum) with those of the ranks
    that hold the same ones.  Under rules whose ``kv_shard`` is
    ``"seq"`` or ``"batch_seq"`` each attention layer's cache is the
    rank's stripe and decode runs ``dist.seq_decode`` (the prefill runs
    the whole prompt on every rank); ``"batch_seq"`` also splits the rows
    over the batch axes, which must divide ``batch``.  Every rank of a
    stripe group must pick the same token at each step (its first rank's
    token is broadcast and compared; so must every rank of a model-axes
    group), and ``generated`` holds the whole batch on every rank.
    ``return_logits`` adds ``"logits"``: the prefill's last-position
    logits and each decode step's, float32, this rank's rows.
    """
    rules = None
    if mesh is not None:
        scfg = scfg or ShardingConfig(
            data_axes=mesh.axis_names[:1], model_axes=(), fsdp_axes=(),
            kv_shard="none", remat=False)
        rules = serving_rules(scfg, mesh)
    if model is None:
        model = build_model(cfg, seed=seed,
                            device=resolve_device(device)).cast_for_serving()
    elif device is not None \
            and torch.device(device).type != model.device.type:
        raise ValueError(f"model lies on {model.device}, device={device!r}")
    if mesh is not None:
        shard_for_serving(model, scfg, mesh)
    dev = model.device
    max_len = prompt_len + gen
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt_len)),
                             dtype=torch.int64, device=dev)
    rows = slice(0, batch)
    seq_group = batch_group = None
    if mesh is not None and dist.get_world_size() > 1:
        if not _checksum_agrees(model, mesh):
            raise RuntimeError("serve_session: the ranks' parameters differ "
                               "(each rank builds the model from the seed)")
        bax = rules.axes("batch")
        nb = mesh.axes_size(bax)
        if nb > 1:
            if batch % nb:
                raise ValueError(f"batch {batch} does not split over "
                                 f"{nb} ranks of {bax}")
            per = batch // nb
            rows = slice(mesh.index(bax) * per, (mesh.index(bax) + 1) * per)
            batch_group = mesh.group(bax)
        # the ranks that serve the same rows must pick the same tokens
        same = tuple(a for a in mesh.axis_names
                     if a in rules.axes("kv_seq") + rules.axes("heads"))
        if mesh.axes_size(same) > 1:
            seq_group = mesh.group(same)
    tokens = tokens[rows]
    lead = (None if seq_group is None
            else dist.get_global_rank(seq_group, 0))
    sampler = torch.Generator(device=dev)
    sampler.manual_seed(int(seed))

    kept: list[torch.Tensor] = []

    def pick(logits: torch.Tensor) -> torch.Tensor:
        if return_logits:
            kept.append(logits[:, -1:].float().cpu())
        if greedy:
            tok = logits[:, -1:].argmax(dim=-1)
        else:
            probs = torch.softmax(logits[:, -1], dim=-1)
            tok = torch.multinomial(probs, 1, generator=sampler)
        if seq_group is not None:
            # every rank of a stripe group must pick the same token
            lead_tok = tok.clone()
            dist.broadcast(lead_tok, src=lead, group=seq_group)
            if not torch.equal(lead_tok, tok):
                raise RuntimeError(
                    f"serve_session: rank {dist.get_rank()} picked "
                    f"{tok.flatten().tolist()}, rank {lead} "
                    f"{lead_tok.flatten().tolist()}")
        return tok

    b = tokens.shape[0]
    with use_rules(rules):
        _sync(dev)
        t0 = time.perf_counter()
        if cfg.encdec:
            frames = torch.as_tensor(
                (rng.standard_normal((batch, prompt_len, cfg.d_model))
                 .astype(np.float32) * np.float32(0.02))[rows], device=dev)
            state = model.init_decode_state(b, max_len,
                                            cross_len=prompt_len)
            state = model.prefill_cross(state, frames)
            start_pos = 0
            last = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        else:
            logits, state = model.prefill(tokens, max_len=max_len)
            start_pos = prompt_len
            last = pick(logits)
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        out = [last]
        t0 = time.perf_counter()
        for i in range(gen - 1):
            logits, state = model.decode_step(state, last, start_pos + i)
            last = pick(logits)
            out.append(last)
        generated = torch.cat(out, dim=1)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    if batch_group is not None:
        # the whole batch on every rank: each rank's rows, zeros elsewhere
        whole = torch.zeros((batch, gen), dtype=torch.int64, device=dev)
        whole[rows] = generated
        dist.all_reduce(whole, group=batch_group)
        generated = whole
    result = {
        "generated": generated.cpu().numpy(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tokens_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
    }
    if return_logits:
        result["logits"] = kept
    return result


def _stream_step_builder(model, *, prompt_len: int, gen: int, seed: int,
                         cfg=None):
    """Per-group prefill+decode step factory shared by ``serve_stream``
    and the split tuner (same chunk contract).

    Each group serves from its own copy of the weights on its device:
    ``model`` itself where it already lies there, a copy otherwise, or
    (``model=None``) a model built from ``cfg`` and ``seed`` there.  A card
    group's step enqueues prefill and decode and returns an
    ``EventHandle``; a CPU group's runs on the group's worker thread and
    returns a ``FutureHandle``."""
    from ..runtime.stream import (EventHandle, FutureHandle, group_device,
                                  host_executor)

    max_len = prompt_len + gen

    def step_builder(group: DeviceGroup):
        dev = group_device(group)
        if model is not None and model.device == dev:
            m = model
        elif model is not None:
            m = copy.deepcopy(model).to(dev)
        else:
            m = build_model(cfg, seed=seed,
                            device=resolve_device(dev)).cast_for_serving()

        def generate(tokens):
            with torch.inference_mode():
                tokens = torch.as_tensor(tokens).to(dev, non_blocking=True)
                logits, state = m.prefill(tokens, max_len=max_len)
                last = logits[:, -1:].argmax(dim=-1)
                outs = [last]
                for i in range(gen - 1):
                    logits, state = m.decode_step(state, last, prompt_len + i)
                    last = logits[:, -1:].argmax(dim=-1)
                    outs.append(last)
                return torch.cat(outs, dim=1)

        if dev.type == "cpu":
            pool = host_executor()

            def host_fn(chunk):
                return FutureHandle(pool.submit(generate, chunk["tokens"]))
            return host_fn

        def card_fn(chunk):
            with torch.cuda.device(dev):
                out = generate(chunk["tokens"])
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            return EventHandle(out, done)
        return card_fn

    return step_builder


def _memoize_per_group(step_builder):
    """Cache the per-group step closures (weights on the group's device,
    worker threads) so a builder shared between ``tune_stream_split`` and
    ``serve_stream`` builds each group's step exactly once."""
    cache: dict[int, object] = {}

    def memoized(group: DeviceGroup):
        key = id(group)
        if key not in cache:
            cache[key] = step_builder(group)
        return cache[key]
    return memoized


# the host group's share of a batch in the paper's space, percent: 0 (the
# card alone) and 2^-8 .. 2^-1, one host row up to half of a 256-row batch
HOST_FRACTIONS = (0.0, 0.390625, 0.78125, 1.5625, 3.125, 6.25, 12.5, 25.0,
                  50.0)


def split_space() -> ConfigSpace:
    """The paper's split space as this machine has it (``core.space.
    paper_space``'s axes): the host group's intra-op threads (powers of two
    up to ``os.cpu_count()``), how they are pinned
    (``runtime.stream.AFFINITIES``) and the host's share of each batch
    (``HOST_FRACTIONS``, percent)."""
    from ..runtime.stream import AFFINITIES

    n = max(int(os.cpu_count() or 1), 1)
    threads = tuple(1 << i for i in range(n.bit_length()) if 1 << i <= n)
    return ConfigSpace([
        Param("host_threads", threads),
        Param("host_affinity", AFFINITIES, ordinal=False),
        Param("host_fraction", HOST_FRACTIONS),
    ])


def _no_failures(rec: dict, point) -> None:
    """A split tune's step must run every group it was given: the
    scheduler hands a failed group's rows to the other, so the step's time
    would not be the point's."""
    if rec["failures"]:
        raise RuntimeError(f"split tune at {point}: group failures "
                           f"{rec['failures']}")


def tune_stream_split(cfg, *, groups: list[DeviceGroup], batch: int = 8,
                      prompt_len: int = 16, gen: int = 8, seed: int = 0,
                      strategy: str | None = None, iterations: int = 10,
                      store=None, chunks_per_group: int = 2,
                      row_quantum: int = 2, model=None, step_builder=None,
                      sample: dict | None = None, space: str = "fraction",
                      workload=None, device=None, clock=None,
                      measurements: list | None = None):
    """Offline-tune the initial two-group split through ``repro_torch.tune``.

    The paper's loop at serve time: one measurement is a chunk-scheduled
    dispatch (rebalance off) of a representative batch (``sample``, or a
    random ``(batch, prompt_len)`` token batch of ``cfg``), and the winner
    is stored in ``store`` per (batch shape x group topology) workload
    signature, so a session on a known workload starts at the tuned split
    with zero new measurements.  Returns (shares for the controller, the
    ``TuneResult``).

    ``space="fraction"`` is the reference's: the first group's share in
    10 % steps, searched by ``strategy`` (default ``sam``).
    ``space="paper"`` is :func:`split_space` with ``groups[0]`` the host
    group: ``strategy`` (default ``saml``) searches a BDTR surrogate fit on
    a training sample sized as ``tune_kernel`` sizes it (at most 5 % of
    the space measured in all), the result is the
    fastest point measured, and the winner's host threads and affinity
    are applied to ``step_builder`` (its ``set_host``).  A host fraction
    of 0 drops the host group for that measurement (the card alone).
    ``device`` keys the store's device topology (``None`` = the card);
    ``clock`` (e.g. a ``VirtualClock`` shared with a simulated
    ``step_builder``) replaces the wall clock of the measurements;
    ``measurements`` (a list, paper space) receives each measured point's
    config and metrics (``time``, ``t_host``, ``t_device``,
    ``rows_host``).
    """
    from ..runtime import ChunkedScheduler, EwmaController
    from ..tune import TuningSession

    if len(groups) != 2:
        raise ValueError("tune_stream_split needs exactly two device groups")
    if space not in ("fraction", "paper"):
        raise ValueError(f"space must be 'fraction' or 'paper', got {space!r}")
    if step_builder is None:
        model = model if model is not None else build_model(
            cfg, seed=seed, device=device).cast_for_serving()
        step_builder = _stream_step_builder(model, prompt_len=prompt_len,
                                            gen=gen, seed=seed)
    if sample is None:
        rng = np.random.default_rng(seed)
        sample = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)))}
    controller = EwmaController(2)
    sched = ChunkedScheduler(
        step_builder, groups, controller=controller,
        chunks_per_group=chunks_per_group, row_quantum=row_quantum,
        clock=clock)
    if workload is None and store is not None:
        workload = {"batch": (batch, prompt_len, gen), "arch": cfg.name,
                    "groups": [(g.name, len(g.devices), g.work_multiplier)
                               for g in groups]}
    if space == "fraction":
        cspace = ConfigSpace([Param("fraction", tuple(range(10, 100, 10)))])

        def measure(cfg_point):
            f = cfg_point["fraction"] / 100.0
            controller.shares = np.asarray([f, 1.0 - f])
            rec = sched.step(sample, rebalance=False)
            _no_failures(rec, cfg_point)
            return {"time": rec["t_step"], "t_host": rec["t_group"][0],
                    "t_device": rec["t_group"][1]}

        session = TuningSession(cspace, evaluator=measure, store=store,
                                workload=workload, device=device)
        result = session.run(strategy or "sam", iterations=iterations,
                             seed=seed)
        f = result.best_config["fraction"] / 100.0
        return np.asarray([f, 1.0 - f]), result
    return _tune_paper_split(sched, step_builder, sample, store, workload,
                             strategy or "saml", iterations, seed, device,
                             measurements)


def _tune_paper_split(sched, step_builder, sample, store, workload,
                      strategy, iterations, seed, device, measurements):
    """``tune_stream_split(space="paper")``: ``tune_kernel``'s loop
    (``tune.kernels.tune_space``) over the host split space."""
    from ..tune import TuningSession
    from ..tune.kernels.tuner import tune_space

    set_host = getattr(step_builder, "set_host", None)

    def apply(point):
        if set_host is not None:
            set_host(point["host_threads"], point["host_affinity"])
        f = point["host_fraction"] / 100.0
        if f == 0.0:
            sched.drop_group(0, reason="split: host fraction 0")
        else:
            sched.restore_group(0)
            sched.controller.shares = np.asarray([f, 1.0 - f])

    seen: dict[tuple, dict] = {}

    def measure(point):
        key = tuple(sorted(point.items()))
        if key in seen:
            return seen[key]
        apply(point)
        if not seen:                         # warm the path: not measured
            sched.step(sample, rebalance=False)
        rec = sched.step(sample, rebalance=False)
        _no_failures(rec, point)
        seen[key] = {"time": rec["t_step"], "t_host": rec["t_group"][0],
                     "t_device": rec["t_group"][1],
                     "rows_host": float(rec["rows"][0])}
        if measurements is not None:
            measurements.append({**point, **seen[key]})
        return seen[key]

    cspace = split_space()
    default = {"host_threads": cspace["host_threads"].values[-1],
               "host_affinity": "none", "host_fraction": 0.0}
    result, _ = tune_space(
        cspace, measure, default=default, workload=workload,
        store=TuningSession._as_store(store, device), strategy=strategy,
        iterations=iterations, seed=seed, device=device,
        what="split space")
    best = result.best_config
    apply(best)
    f = best["host_fraction"] / 100.0
    return np.asarray([f, 1.0 - f]), result


def serve_stream(cfg, *, groups: list[DeviceGroup], n_batches: int = 4,
                 batch: int = 8, prompt_len: int = 16, gen: int = 8,
                 seed: int = 0, chunks_per_group: int = 2,
                 row_quantum: int = 2, controller=None,
                 initial_shares=None, model=None,
                 step_builder=None, guard=None, observer=None,
                 clock=None, injector=None, batches=None) -> dict:
    """Adaptive serving: chunk-schedule batches across groups.

    Each group holds its own copy of the weights and runs full
    prefill+decode for the request rows it is handed (``step_builder``
    overrides the step, e.g. ``runtime.dna_stream_builder`` with
    ``batches`` of DNA text); the ``StreamingPipeline``'s EWMA controller
    moves rows between groups as measured per-chunk times come in.
    Decoder-only models.  ``row_quantum`` coarsens chunk sizes.
    ``initial_shares`` (e.g. from ``tune_stream_split``) starts the
    controller at a tuned split; a group whose initial share is 0 starts
    dropped (the tuner found the stream faster without it).  ``guard``
    (``True`` or a preconfigured ``repro_torch.runtime.ServeGuard``) adds
    the kill-switch guardrail.

    ``observer`` (``repro_torch.obs.Observer``) records the run;
    ``clock`` passes through to the scheduler (share it with the observer
    and a sim ``step_builder`` for deterministic traces); ``injector`` (a
    ``repro_torch.runtime.FaultInjector``) is ticked once per batch and
    attached so recover events restore membership — the fault-drill
    surface behind ``--fault-plan``.
    """
    from ..runtime import EwmaController, StreamingPipeline

    if cfg is not None and cfg.encdec:
        raise ValueError("serve_stream supports decoder-only models")
    n_devices = sum(len(g.devices) for g in groups)
    if batch < n_devices:
        raise ValueError(
            f"--batch {batch} is smaller than one request per device "
            f"({n_devices}); raise --batch or use fewer devices/groups")
    if step_builder is None:
        step_builder = _stream_step_builder(model, prompt_len=prompt_len,
                                            gen=gen, seed=seed, cfg=cfg)
    if controller is None and initial_shares is not None:
        shares = np.asarray(initial_shares, np.float64)
        controller = EwmaController(len(groups), shares=shares,
                                    live=shares > 0)

    pipeline = StreamingPipeline(
        step_builder, groups, chunks_per_group=chunks_per_group,
        row_quantum=row_quantum, controller=controller, guard=guard,
        clock=clock, observer=observer)
    if batches is None:
        rng = np.random.default_rng(seed)
        batches = [{"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (batch, prompt_len)))}
            for _ in range(n_batches)]
    if injector is not None:
        # route recover events through the membership surface, and feed
        # the scripted plan one scheduler step at a time
        injector.attach(pipeline.guard if pipeline.guard is not None
                        else pipeline.scheduler)
        records = []
        for b in batches:
            injector.tick()
            records.extend(pipeline.run([b]))
    else:
        records = pipeline.run(batches)
    summary = pipeline.summary()
    summary["tokens_per_s_mean"] = summary["rows_per_s_mean"] * gen
    return {"records": records, "summary": summary}


def serve_requests(cfg, *, groups: list[DeviceGroup] | None = None,
                   n_requests: int, rate_rps: float, prompt_len: int,
                   gen: int, seed: int = 0, batcher_config=None,
                   guard: bool = False, observer=None, row_quantum: int = 1,
                   model=None, step_builder=None) -> dict:
    """Request-level serving on real devices: the ``repro_torch.serve``
    engine over a prefill+decode step builder.

    Every request asks for rows of one ``(prompt_len, gen)`` shape (the
    arrival process, priorities and SLOs come from the source's default
    mix); the continuous batcher re-forms a scheduler batch per step from
    whatever is queued, and the chunked scheduler splits each batch across
    ``groups`` (default: one group on the card).
    ``model`` serves an already-built ``LM`` on the groups that share its
    device.  A card group's step returns once its work is enqueued; the
    scheduler's drain thread stamps each row's completion when the card's
    event completes, and a request completes at the latest of its rows.
    Arrival waits are real ``time.sleep`` — for the deterministic
    virtual-clock rig use ``repro_torch.serve.make_sim_engine`` (the
    ``--sim-serve`` / ``--fault-plan`` path).
    """
    from ..runtime import ChunkedScheduler, ServeGuard
    from ..serve import (AdmissionController, BatcherConfig,
                         ContinuousBatcher, RequestSource, ServeEngine,
                         SloPolicy)

    if groups is None:
        groups = [DeviceGroup("all", [resolve_device(None)])]
    if step_builder is None:
        if cfg.encdec:
            raise ValueError("serve_requests serves decoder-only models "
                             "(its step prefills a token prompt)")
        step_builder = _memoize_per_group(_stream_step_builder(
            model, prompt_len=prompt_len, gen=gen, seed=seed, cfg=cfg))
    # anchor arrivals on the engine's wall clock (the sim rig's
    # VirtualClock starts at 0; perf_counter does not)
    source = RequestSource(n_requests=n_requests, rate_rps=rate_rps,
                           seed=seed, shapes=((prompt_len, gen),),
                           rows_choices=(1, 2, 4),
                           start=time.perf_counter())
    rng = np.random.default_rng(seed)
    pin = any(getattr(d, "type", None) == "cuda" for g in groups
              for d in g.devices)

    def payload_fn(shape, rows):
        # the reference's integers, as a host tensor (pinned for a card
        # group, whose step copies its rows without blocking)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (rows, shape[0])))
        return {"tokens": tokens.pin_memory() if pin else tokens}

    scheduler = ChunkedScheduler(step_builder, groups,
                                 row_quantum=max(row_quantum, 1),
                                 observer=observer)
    target = ServeGuard(scheduler) if guard else scheduler
    bcfg = batcher_config or BatcherConfig()
    engine = ServeEngine(
        target, source=source,
        admission=AdmissionController(
            SloPolicy(max_queue_rows=bcfg.queue_depth_rows)),
        batcher=ContinuousBatcher(bcfg),
        payload_fn=payload_fn, observer=observer)
    summary = engine.run()
    summary["tokens_per_s"] = summary.get("goodput_rows_per_s", 0.0) * gen
    return {"summary": summary,
            "records": [r.record() for r in engine.done]}


def dna_stream_batches(n_batches: int, rows: int, row_len: int, *,
                       seed: int = 0, pin: bool = False) -> list[dict]:
    """``n_batches`` batches of ``{"text": (rows, row_len) uint8}`` random
    DNA on the host (pinned with ``pin``), made in one piece from
    ``seed``."""
    from ..kernels.dna_automaton.ops import random_dna_text

    text = random_dna_text(n_batches * rows * row_len, seed=seed,
                           device="cpu").view(n_batches * rows, row_len)
    if pin:
        text = text.pin_memory()
    return [{"text": text[i * rows:(i + 1) * rows]}
            for i in range(n_batches)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-shard", default="none",
                    choices=["none", "heads", "seq", "batch_seq"],
                    help="under torchrun: the decode caches' layout over the "
                    "ranks (seq: each rank a stripe of the sequence, the "
                    "batch on every rank; heads: each rank the kv heads "
                    "of its q heads, with --mesh splitting the model axis)")
    add_mesh_args(ap)
    ap.add_argument("--fsdp-axes", default="",
                    help="under torchrun: mesh axes over which each rank "
                    "stores its block of the parameters, gathering a "
                    "layer's where it runs, e.g. 'data'")
    ap.add_argument("--tuned-kernels", default=None, metavar="STORE",
                    help="kernel tuning store (JSON from "
                    "repro_torch.tune.kernels.tune_kernel): the kernels "
                    "resolve their cached best launch params per shape, "
                    "defaults on a miss")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                    "kernels' plain PyTorch versions)")
    ap.add_argument("--stream", action="store_true",
                    help="adaptive chunk-scheduled serving "
                    "(repro_torch.runtime)")
    ap.add_argument("--stream-workload", default="lm", choices=["lm", "dna"],
                    help="lm: prefill+decode request batches; dna: the "
                    "paper's motif count streamed host -> device")
    ap.add_argument("--stream-batches", type=int, default=4)
    ap.add_argument("--row-len", type=int, default=1 << 16,
                    help="DNA symbols a row (--stream-workload dna)")
    ap.add_argument("--motif", default="ACGTAC",
                    help="motif counted (--stream-workload dna)")
    ap.add_argument("--slow", type=int, default=0,
                    help="reserve the last N devices as a second group")
    ap.add_argument("--tune-split", action="store_true",
                    help="tune the initial two-group split offline "
                    "(repro_torch.tune session) before streaming")
    ap.add_argument("--tune-store", default=None,
                    help="TuningStore JSON path caching tuned splits "
                    "per workload signature")
    ap.add_argument("--tune-strategy", default=None,
                    help="registered strategy for --tune-split (default "
                    "sam for lm, saml for dna)")
    ap.add_argument("--guard", action="store_true",
                    help="kill-switch guardrail: pin the last known-good "
                    "static split when the online controller regresses")
    ap.add_argument("--guard-threshold", type=float, default=1.5,
                    help="trip when step time exceeds this multiple of "
                    "the rolling baseline")
    ap.add_argument("--guard-patience", type=int, default=5,
                    help="consecutive regressing steps before tripping")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a chrome://tracing span trace of the "
                    "--stream run (repro_torch.obs)")
    ap.add_argument("--journal-out", default=None, metavar="PATH",
                    help="write the decision journal (JSONL) of the "
                    "--stream run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write obs_summary.json (counters, latency "
                    "percentiles, journal digest, provenance meta)")
    ap.add_argument("--log-level", default=None,
                    choices=["debug", "info", "warning", "error"],
                    help="filter the structured log (default info; also "
                    "REPRO_LOG_LEVEL)")
    ap.add_argument("--fault-plan", default=None, metavar="SPEC",
                    help="scripted failure drill for --stream or "
                    "--serve-requests, e.g. 'kill:0@3,slow:1@9:4' (also "
                    "crash:0@N / torn:0@N for --serve-requests) — runs "
                    "against simulated serial groups on a virtual clock "
                    "(no model build); see "
                    "repro_torch.runtime.parse_fault_plan")
    ap.add_argument("--sim-devices", type=int, default=8,
                    help="device count of the simulated groups under "
                    "--fault-plan")
    ap.add_argument("--serve-requests", type=int, default=None, metavar="N",
                    help="request-level serving (repro_torch.serve): N "
                    "requests from a deterministic arrival source through "
                    "admission -> continuous batching -> the chunked "
                    "scheduler")
    ap.add_argument("--request-rate", type=float, default=200.0,
                    help="offered load for --serve-requests (requests/s)")
    ap.add_argument("--serve-seed", type=int, default=0,
                    help="seed of the request arrival source")
    ap.add_argument("--sim-serve", action="store_true",
                    help="run --serve-requests on the deterministic sim "
                    "rig (VirtualClock, no model build) even without a "
                    "--fault-plan")
    ap.add_argument("--tune-batcher", action="store_true",
                    help="tune the continuous-batcher knobs through a "
                    "TuningSession (sim-rig evaluations) before serving")
    ap.add_argument("--batcher-store", default=None, metavar="PATH",
                    help="TuningStore JSON caching tuned batcher configs "
                    "per workload signature")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="write-ahead request log for --serve-requests "
                    "(sim rig): every admit/retire/step is appended "
                    "before the engine proceeds, so a crashed run can "
                    "restart with --resume")
    ap.add_argument("--snapshot", default=None, metavar="PATH",
                    help="periodic checksummed snapshot of the engine's "
                    "soft state (controller shares, kill-switch, service "
                    "estimator) next to the --wal")
    ap.add_argument("--resume", action="store_true",
                    help="recover from --wal (and --snapshot if given) "
                    "before serving: unretired admitted requests replay "
                    "through admission, the clock and fault plan fast-"
                    "forward to the crash point")
    ap.add_argument("--crash-sigkill", action="store_true",
                    help="scripted crash faults (--fault-plan 'crash:0@N') "
                    "kill the process with SIGKILL instead of raising — "
                    "the real-process recovery drill")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    if args.serve_requests:
        _main_requests(ap, args)
        return
    if args.stream:
        _main_stream(ap, args)
        return
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    dev = resolve_device(args.device)
    if args.tuned_kernels:
        from ..tune import kernels as ktune
        ktune.configure(args.tuned_kernels, device=dev)
    # under torchrun: the ranks of the group, the caches laid out by
    # --kv-shard ("seq" and "batch_seq" run the sequence-sharded decode)
    # (--mesh over (data, model) with the model axes splitting the heads)
    mesh = scfg = None
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        world = int(os.environ["WORLD_SIZE"])
        shape = (2, world // 2) if args.kv_shard == "batch_seq" else None
        mesh = (mesh_from_args(args, dev) if args.mesh else make_host_mesh(
            axes=("data", "model") if shape else ("data",), shape=shape,
            device=dev))
        scfg = ShardingConfig(data_axes=("data",),
                              model_axes=axes_arg(args.model_axes)
                              or ("model",),
                              fsdp_axes=axes_arg(args.fsdp_axes),
                              kv_shard=args.kv_shard)
    out = serve_session(cfg, batch=args.batch, prompt_len=args.prompt_len,
                        gen=args.gen, seed=args.seed, device=dev, mesh=mesh,
                        scfg=scfg)
    ranks = ("" if mesh is None else
             f" on rank {dist.get_rank()} of {dist.get_world_size()}")
    log.info(f"prefill {out['prefill_s']:.3f}s  decode {out['decode_s']:.3f}s"
             f"  {out['tokens_per_s']:.1f} tok/s on {dev}{ranks}")
    log.info(f"sample tokens: {out['generated'][0, :12]}")
    if mesh is not None:
        dist.destroy_process_group()


def _main_requests(ap, args) -> None:
    """``--serve-requests``: the request engine on the sim rig (with the
    crash drill and its recovery) or on the arch's model."""
    from ..obs import Observer, configure
    from ..serve import make_sim_engine, tune_batcher

    slog = get_logger("repro_torch.serve")
    if args.log_level:
        configure(level=args.log_level)
    observer = None
    journal_sink = None
    if args.trace_out or args.journal_out or args.metrics_out:
        observer = Observer()
        if args.journal_out:
            # stream every event as it happens (line-buffered + per-event
            # flush): a SIGKILL mid-run still leaves the journal on disk
            # up to the last decision.  save_journal rewrites the same
            # bytes at a clean exit.
            from pathlib import Path
            Path(args.journal_out).parent.mkdir(parents=True, exist_ok=True)
            journal_sink = open(args.journal_out, "w", buffering=1)
            observer.journal.sink = journal_sink
        configure(journal=observer.journal)
    sim = bool(args.fault_plan or args.sim_serve)
    if (args.wal or args.resume) and not sim:
        ap.error("--wal/--resume need the sim rig "
                 "(--sim-serve or --fault-plan)")
    if args.resume and not args.wal:
        ap.error("--resume needs --wal")
    bcfg = None
    if args.tune_batcher:
        # tune on the sim rig (cheap, deterministic); the store re-serves
        # a known workload with zero new measurements
        from ..runtime import TuningStore
        store = (TuningStore(args.batcher_store, device="cpu")
                 if args.batcher_store else None)
        workload = {"n_requests": args.serve_requests,
                    "rate_rps": args.request_rate, "seed": args.serve_seed}

        def evaluate(cand):
            eng = make_sim_engine(n_requests=args.serve_requests,
                                  rate_rps=args.request_rate,
                                  seed=args.serve_seed, batcher_config=cand)
            s = eng.run()
            return {"time": s.get("e2e_p95", 10.0) + 0.1 * s["shed_rate"],
                    "shed_rate": s["shed_rate"]}

        bcfg, tuned = tune_batcher(evaluate, store=store, workload=workload,
                                   observer=observer)
        slog.info(f"tuned batcher: {bcfg} "
                  f"({tuned.n_experiments} measurements, "
                  f"{100 * tuned.experiments_fraction:.1f}% of space"
                  f"{', cached' if tuned.from_cache else ''})")
    if sim:
        from ..runtime.checkpoint import SimulatedCrash
        from ..runtime.simulate import parse_fault_plan
        plan = parse_fault_plan(args.fault_plan) if args.fault_plan else None
        engine = make_sim_engine(
            n_requests=args.serve_requests, rate_rps=args.request_rate,
            seed=args.serve_seed, fault_plan=plan,
            guard=args.guard or bool(plan), batcher_config=bcfg,
            observer=observer, wal=args.wal, snapshot=args.snapshot,
            resume=args.resume,
            crash_mode="sigkill" if args.crash_sigkill else "raise")
        try:
            s = engine.run()
        except SimulatedCrash as exc:
            # scripted crash drill (crash_mode="raise"): the WAL and the
            # streamed journal are already durable — flush what there is
            # and exit with the drill's code, so a caller can tell that
            # the crash fired before the restart
            slog.warning(f"simulated crash: {exc}", steps=engine.steps)
            if engine.wal is not None:
                engine.wal.sync()
            if journal_sink is not None:
                journal_sink.close()
            raise SystemExit(17)
    else:
        cfg = configs.get(args.arch)
        if args.smoke:
            cfg = cfg.smoke()
        dev = resolve_device(args.device)
        if args.tuned_kernels:
            from ..tune import kernels as ktune
            ktune.configure(args.tuned_kernels, device=dev)
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])[:max(args.batch, 1)]
        if 0 < args.slow < len(devs):
            groups = [DeviceGroup("fast", devs[:-args.slow]),
                      DeviceGroup("slow", devs[-args.slow:])]
        else:
            groups = [DeviceGroup("all", devs)]
        out = serve_requests(
            cfg, groups=groups, n_requests=args.serve_requests,
            rate_rps=args.request_rate, prompt_len=args.prompt_len,
            gen=args.gen, seed=args.serve_seed, batcher_config=bcfg,
            guard=args.guard, observer=observer)
        s = out["summary"]
    replayed = f"  {s['replayed']} replayed" if s.get("replayed") else ""
    slog.info(f"serve: {s['completed']}/{s['requests']} completed  "
              f"{s['shed']} shed {s['shed_reasons']}  "
              f"{s['retries']} retries{replayed}  "
              f"e2e p99 {s.get('e2e_p99', float('nan')):.4f}s")
    if observer is not None:
        if args.trace_out:
            path = observer.save_trace(args.trace_out)
            slog.info(f"trace: {path} ({len(observer.tracer)} events)")
        if args.journal_out:
            # close the stream first; save() rewrites the identical bytes
            if journal_sink is not None:
                journal_sink.close()
                observer.journal.sink = None
            path = observer.save_journal(args.journal_out)
            slog.info(f"journal: {path} ({len(observer.journal)} events)")
        if args.metrics_out:
            observer.write_summary(args.metrics_out, extra={"serve": s})
            slog.info(f"metrics: {args.metrics_out}")


def _main_stream(ap, args) -> None:
    """``--stream``: the online runtime, the DNA stream or the fault drill."""
    from ..obs import Observer, configure
    from ..runtime import KillSwitch, ServeGuard

    slog = get_logger("repro_torch.serve")
    if args.log_level:
        configure(level=args.log_level)
    cfg = configs.get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    clock = injector = observer = None
    dna = args.stream_workload == "dna"
    if args.fault_plan:
        if args.tune_split:
            ap.error("--fault-plan is a simulated drill; it cannot "
                     "combine with --tune-split")
        from ..runtime.simulate import (FakeDevice, FaultInjector,
                                        VirtualClock,
                                        make_serial_sim_builder,
                                        parse_fault_plan)
        # the drill runs against simulated serial groups on a virtual
        # clock: no model, no kernels, and every timestamp in the
        # trace/journal is a deterministic simulated instant
        clock = VirtualClock()
        devs = [FakeDevice()
                for _ in range(min(args.sim_devices, max(args.batch, 1)))]
        if 0 < args.slow < len(devs):
            groups = [DeviceGroup("fast", devs[:-args.slow]),
                      DeviceGroup("slow", devs[-args.slow:])]
        else:
            groups = [DeviceGroup("all", devs)]
    else:
        dev = resolve_device(args.device)
        if args.tuned_kernels:
            from ..tune import kernels as ktune
            ktune.configure(args.tuned_kernels, device=dev)
        if dna:
            # the host group is the CPU; the device group is the card (or,
            # with --device cpu, a second CPU group)
            groups = [DeviceGroup("host", [torch.device("cpu")]),
                      DeviceGroup("device", [dev])]
        else:
            devs = ([torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
                    if dev.type == "cuda" else [dev])[:max(args.batch, 1)]
            if 0 < args.slow < len(devs):
                groups = [DeviceGroup("fast", devs[:-args.slow]),
                          DeviceGroup("slow", devs[-args.slow:])]
            else:
                groups = [DeviceGroup("all", devs)]
    if args.trace_out or args.journal_out or args.metrics_out:
        observer = Observer(clock=clock)
        # mirror every narrated line into the decision journal, so the
        # narration and the decisions land on one sequence
        configure(journal=observer.journal)
    batches = None
    if args.fault_plan:
        injector = FaultInjector(parse_fault_plan(args.fault_plan), groups)
        builder = make_serial_sim_builder(1e-3, clock=clock,
                                          injector=injector)
        if dna:
            batches = [{"text": np.zeros((args.batch, 1), np.uint8)}
                       for _ in range(args.stream_batches)]
    elif dna:
        from ..kernels.dna_automaton.ops import build_motif_dfa
        from ..runtime import dna_stream_builder

        table, accept = build_motif_dfa(args.motif)
        builder = dna_stream_builder(table, accept)
        batches = dna_stream_batches(args.stream_batches, args.batch,
                                     args.row_len, seed=args.seed,
                                     pin=dev.type == "cuda")
    else:
        # one memoized builder: the split tuner and the serving pipeline
        # share each group's weights and worker
        builder = _memoize_per_group(_stream_step_builder(
            None, prompt_len=args.prompt_len, gen=args.gen, seed=args.seed,
            cfg=cfg))
    initial_shares = None
    if args.tune_split:
        if len(groups) != 2:
            ap.error("--tune-split needs two groups (pass --slow N, or "
                     "--stream-workload dna)")
        kw = {}
        if dna:
            kw = dict(sample=batches[0], space="paper", workload={
                "stream": "dna", "motif": args.motif, "rows": args.batch,
                "row_len": args.row_len,
                "groups": [(g.name, str(g.devices[0]), g.work_multiplier)
                           for g in groups]})
        initial_shares, tuned = tune_stream_split(
            cfg, groups=groups, batch=args.batch,
            prompt_len=args.prompt_len, gen=args.gen,
            strategy=args.tune_strategy, store=args.tune_store,
            step_builder=builder, device=dev, **kw)
        slog.info(f"tuned split: {initial_shares.round(4)} "
                  f"{tuned.best_config} ({tuned.strategy}, "
                  f"{tuned.n_measured} measured of {tuned.space_size}"
                  f"{', cached' if tuned.from_cache else ''})")
    guard = None
    if args.guard:
        # last known-good fallback: the tuned split when there is one
        # (tuner-measured, the strongest prior); otherwise the guard
        # snapshots the best online split it observes
        guard = ServeGuard(
            None, switch=KillSwitch(threshold=args.guard_threshold,
                                    patience=args.guard_patience),
            fallback=initial_shares)
    out = serve_stream(cfg, groups=groups, n_batches=args.stream_batches,
                       batch=args.batch, prompt_len=args.prompt_len,
                       gen=args.gen, initial_shares=initial_shares,
                       step_builder=builder, guard=guard,
                       observer=observer, clock=clock,
                       injector=injector, batches=batches)
    if hasattr(builder, "close"):
        builder.close()
    s = out["summary"]
    guarded = f"  guard trips {s['guard_trips']}" if args.guard else ""
    rate = (f"{s['rows_per_s_mean'] * args.row_len / 1e6:.1f} MB/s" if dna
            else f"{s['tokens_per_s_mean']:.1f} tok/s")
    slog.info(f"stream: {s['batches']} batches  {rate}  "
              f"shares {s['shares_final']}  live {s['live_final']}"
              f"{guarded}")
    failed = {g: e for r in out["records"] for g, e in r["failures"].items()}
    if observer is not None:
        if args.trace_out:
            path = observer.save_trace(args.trace_out)
            slog.info(f"trace: {path} ({len(observer.tracer)} events)")
        if args.journal_out:
            path = observer.save_journal(args.journal_out)
            slog.info(f"journal: {path} ({len(observer.journal)} events)")
        if args.metrics_out:
            observer.write_summary(args.metrics_out, extra={"stream": s})
            slog.info(f"metrics: {args.metrics_out}")
    if failed and injector is None:
        # outside a drill a failed group is a fault, not a split: the
        # scheduler ran its rows on the survivors (a failed card's on the
        # host's plain DFA), so the run must not pass for a healthy one
        raise SystemExit(f"stream: group failures {failed}")


if __name__ == "__main__":
    main()
