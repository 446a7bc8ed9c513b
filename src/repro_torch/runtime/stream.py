"""Streaming pipeline: overlapped transfer/compute over device groups.

The paper's workload is a stream: DNA text flows host -> device, the DFA
runs per chunk, counts flow back.  This module runs that shape through
the chunked scheduler: each incoming batch is sliced into chunks, and
every chunk a card group takes is copied from (pinned) host memory on a
side copy stream (the *transfer* stage) and counted by the state-map and
count kernels on the compute stream, which waits on the copy's event
(the *compute* stage).  Nothing waits on the host, so the copy of chunk
k+1 overlaps the kernels of chunk k.  A host group — a group whose
devices are the CPU, a device group of its own and not a fallback — runs
the plain DFA (``fa_match_rows_plain``) on a worker thread of its own.
The EWMA controller adapts the per-group split while the stream runs.

A step returns a handle at once: :class:`EventHandle` (a card result and
the CUDA event recorded after its kernels) or :class:`FutureHandle` (a
host result's future).  The scheduler's drain threads wait on
``block_until_ready``: ``torch.cuda.Event.synchronize`` or
``Future.result``, both of which release the GIL.

``dna_stream_builder`` builds the per-group step function for the
paper's motif-count workload; ``StreamingPipeline`` drives any step
builder — ``launch/serve.py`` uses it with a prefill+decode builder too.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from ..core.hetero import DeviceGroup
from .guard import ServeGuard
from .scheduler import ChunkedScheduler, EwmaController

__all__ = ["AFFINITIES", "DnaStreamBuilder", "HOST_CHUNK", "EventHandle", "FutureHandle",
           "StreamingPipeline", "affinity_cpus", "dna_stream_builder",
           "group_device", "host_executor"]

# how a host group's worker threads are pinned: "none" keeps the process's
# CPU set, "compact" takes the first n CPUs, "scatter" every (N/n)-th
AFFINITIES = ("none", "compact", "scatter")
# the host group's plain-DFA chunk: the plain versions step every chunk one
# symbol a call, so short chunks give each call more chunks to vectorize
# over (64: the fastest of 16-2048 on 1 and 8 threads of an 8-CPU host)
HOST_CHUNK = 64


class EventHandle:
    """A card step's result: ``value`` (a tensor on the card, maybe not
    computed yet) and the CUDA event recorded on the compute stream after
    the work that produces it."""

    def __init__(self, value: torch.Tensor, event: torch.cuda.Event):
        self.value = value
        self.event = event

    def block_until_ready(self) -> "EventHandle":
        self.event.synchronize()
        return self


class FutureHandle:
    """A host step's result: the future of its worker thread.  Waiting
    re-raises whatever the worker raised (the scheduler's demotion
    boundary)."""

    def __init__(self, future: Future):
        self.future = future

    @property
    def value(self):
        return self.future.result()

    def is_ready(self) -> bool:
        return self.future.done()

    def block_until_ready(self) -> "FutureHandle":
        self.future.result()
        return self


def affinity_cpus(threads: int, affinity: str) -> set[int] | None:
    """The CPU set ``affinity`` gives ``threads`` worker threads (None:
    leave the process's set alone)."""
    if affinity not in AFFINITIES:
        raise ValueError(f"affinity {affinity!r} not in {AFFINITIES}")
    if affinity == "none":
        return None
    cpus = sorted(os.sched_getaffinity(0))
    n = max(1, min(int(threads), len(cpus)))
    if affinity == "compact":
        return set(cpus[:n])
    step = len(cpus) / n
    return {cpus[int(i * step)] for i in range(n)}


def host_executor(threads: int | None = None,
                  affinity: str = "none") -> ThreadPoolExecutor:
    """One worker thread for a host group's steps.

    Its initializer pins the new thread to ``affinity_cpus`` and sets
    ``torch.set_num_threads(threads)``; both act on that thread alone
    (PyTorch's intra-op thread count is a per-thread setting, and the
    intra-op threads the worker starts inherit its CPU set), so the
    caller's threads keep theirs.  A fresh worker is needed for each
    setting: intra-op threads started earlier keep the CPU set they
    started with.
    """
    cpus = affinity_cpus(threads or 1, affinity)

    def init():
        if cpus is not None:
            os.sched_setaffinity(0, cpus)
        if threads:
            torch.set_num_threads(int(threads))

    return ThreadPoolExecutor(max_workers=1, initializer=init,
                              thread_name_prefix="host-group")


def group_device(group: DeviceGroup) -> torch.device:
    """The torch device a group's steps run on (its first device)."""
    dev = group.devices[0]
    if isinstance(dev, (str, torch.device)):
        return torch.device(dev)
    raise TypeError(f"group {group.name!r} holds {type(dev).__name__}, not "
                    "a torch device (simulated groups take a sim builder)")


def dna_stream_builder(table: np.ndarray, accept: np.ndarray
                       ) -> "DnaStreamBuilder":
    """Step-builder for streaming DNA motif counting (see
    :class:`DnaStreamBuilder`)."""
    return DnaStreamBuilder(table, accept)


class DnaStreamBuilder:
    """Step-builder for streaming DNA motif counting.

    ``builder(group)`` returns ``fn(chunk)`` where ``chunk`` is
    ``{"text": (rows, L) uint8}`` (a CPU tensor, pinned for the copy to
    overlap, or an array); ``fn`` returns a handle whose ``value`` is
    the (rows,) int32 match counts, every row from state 0 (the batched
    form of ``kernels.dna_automaton.ref.fa_match_ref``).

      * a card group (CUDA devices): the DFA tables go to the card once,
        here; each call copies the chunk on a side stream with
        ``non_blocking=True``, records an event the compute stream waits
        on, runs ``fa_match_rows(tuned=True)`` (one state-map and one
        count launch) and returns an :class:`EventHandle`.  No call reads
        anything back to the host.
      * a host group (CPU devices): ``fa_match_rows_plain`` at
        ``HOST_CHUNK`` on the group's worker thread (``host_executor`` of
        the setting :meth:`set_host` last made; all CPUs unpinned to
        begin with), returning a :class:`FutureHandle`.

    ``group.work_multiplier`` repeats the work (the slow-group test hook
    the reference keeps).  ``dispatches`` counts calls per group name.
    """

    def __init__(self, table: np.ndarray, accept: np.ndarray):
        self.table = np.asarray(table, np.int32)
        self.accept = np.asarray(accept)
        self.dispatches: dict[str, int] = {}
        self._lock = threading.Lock()
        self._pools: dict[tuple, ThreadPoolExecutor] = {}
        self.host = (None, "none")

    def set_host(self, threads: int | None, affinity: str = "none") -> None:
        """Run later host steps on a worker of ``threads`` intra-op threads
        pinned by ``affinity`` (one worker kept per setting)."""
        affinity_cpus(threads or 1, affinity)          # validate
        self.host = (None if threads is None else int(threads), affinity)

    def _pool(self) -> ThreadPoolExecutor:
        with self._lock:
            pool = self._pools.get(self.host)
            if pool is None:
                pool = self._pools[self.host] = host_executor(*self.host)
            return pool

    def close(self) -> None:
        """Stop the host workers."""
        with self._lock:
            for pool in self._pools.values():
                pool.shutdown(wait=True)
            self._pools.clear()

    def _count(self, group: DeviceGroup) -> None:
        with self._lock:
            self.dispatches[group.name] = \
                self.dispatches.get(group.name, 0) + 1

    def __call__(self, group: DeviceGroup) -> Callable:
        from ..convert import dfa_to_device
        from ..kernels.dna_automaton.ops import (fa_match_rows,
                                                 fa_match_rows_plain)

        dev = group_device(group)
        reps = max(int(group.work_multiplier), 1)
        if dev.type == "cpu":
            table, accept = dfa_to_device(self.table, self.accept, dev)

            def count(texts):
                with torch.inference_mode():
                    total = fa_match_rows_plain(texts, table, accept,
                                                chunk=HOST_CHUNK)
                    for _ in range(reps - 1):
                        total = total + fa_match_rows_plain(
                            texts, table, accept, chunk=HOST_CHUNK)
                    return total // reps

            def host_fn(chunk):
                self._count(group)
                texts = torch.as_tensor(chunk["text"])
                return FutureHandle(self._pool().submit(count, texts))
            return host_fn

        from .. import resolve_device
        dev = resolve_device(dev)                 # raises without a card
        table, accept = dfa_to_device(self.table, self.accept, dev)
        copy_stream = torch.cuda.Stream(dev)

        def card_fn(chunk):
            self._count(group)
            texts = torch.as_tensor(chunk["text"])
            compute = torch.cuda.current_stream(dev)
            if texts.device != dev:
                with torch.cuda.stream(copy_stream):
                    texts = texts.to(dev, non_blocking=True)
                    copied = torch.cuda.Event()
                    copied.record(copy_stream)
                compute.wait_event(copied)
                # the copy was allocated on the copy stream: keep the
                # allocator from reusing it before the kernels read it
                texts.record_stream(compute)
            with torch.cuda.device(dev):
                total = fa_match_rows(texts, table, accept, tuned=True)
                for _ in range(reps - 1):
                    total = total + fa_match_rows(texts, table, accept,
                                                  tuned=True)
                counts = total // reps if reps > 1 else total
                done = torch.cuda.Event()
                done.record(compute)
            return EventHandle(counts, done)
        return card_fn


class StreamingPipeline:
    """Drive a stream of batches through the chunked scheduler and keep
    throughput accounting per batch."""

    def __init__(self, step_builder: Callable[[DeviceGroup], Callable],
                 groups: Sequence[DeviceGroup], *,
                 controller: EwmaController | None = None,
                 chunks_per_group: int = 2, inflight: int = 2,
                 row_quantum: int = 1, clock=None,
                 dispatch_timeout_s: float | None = None,
                 guard: "ServeGuard | bool | None" = None,
                 observer=None):
        """``guard=True`` wraps the scheduler in a default
        :class:`~repro_torch.runtime.guard.ServeGuard` (kill-switch
        fallback to the best split seen); pass a preconfigured
        ``ServeGuard`` (unbound: ``scheduler=None``) to set thresholds or
        a stored fallback split.  ``clock``/``dispatch_timeout_s`` pass
        through to the scheduler; ``observer`` (a
        ``repro_torch.obs.Observer``, default off) flows into the
        scheduler and the guard, and additionally records a per-batch
        stream-latency histogram reported by :meth:`summary`."""
        self.scheduler = ChunkedScheduler(
            step_builder, groups, controller=controller,
            chunks_per_group=chunks_per_group, inflight=inflight,
            row_quantum=row_quantum, clock=clock,
            dispatch_timeout_s=dispatch_timeout_s, observer=observer)
        if guard is True:
            guard = ServeGuard(self.scheduler)
        elif guard is not None and guard.scheduler is None:
            guard.scheduler = self.scheduler
            guard.__post_init__()       # re-validate fallback vs groups
        self.guard = guard or None
        self.records: list[dict] = []
        self._obs = self.scheduler._obs
        if self._obs is not None:
            self._h_batch = self._obs.metrics.histogram("stream.t_step_s")
            self._h_queue = self._obs.metrics.histogram(
                "stream.queue_delay_s")

    @property
    def shares(self) -> np.ndarray:
        return self.scheduler.shares

    def run(self, batches: Iterable[dict], *,
            rebalance: bool = True,
            arrivals: Sequence[float] | None = None) -> list[dict]:
        """Process every batch; returns (and accumulates) per-batch
        records with rows/s throughput and the latency decomposition
        (``queue_delay_s`` waiting before dispatch vs ``service_s`` in
        the scheduler) added.

        ``arrivals`` gives each batch's arrival instant on the
        scheduler's clock; without it every batch counts as having
        arrived when ``run`` was called — batch k's queue delay is then
        the time batches 0..k-1 spent in service ahead of it, which is
        the honest decomposition for a pre-materialized stream."""
        out = []
        t_run0 = self.scheduler._now()
        for i, batch in enumerate(batches):
            arrival = float(arrivals[i]) if arrivals is not None else t_run0
            queue_delay = max(self.scheduler._now() - arrival, 0.0)
            if self.guard is not None:
                rec = self.guard.step(batch)   # guard owns the rebalance flag
            else:
                rec = self.scheduler.step(batch, rebalance=rebalance)
            done = sum(rec["rows_completed"])
            rec = dict(rec, rows_total=int(done),
                       rows_per_s=done / max(rec["t_step"], 1e-9),
                       queue_delay_s=queue_delay,
                       service_s=rec["t_step"],
                       e2e_s=queue_delay + rec["t_step"])
            if self._obs is not None:
                self._h_batch.observe(rec["t_step"])
                self._h_queue.observe(queue_delay)
            out.append(rec)
        self.records.extend(out)
        return out

    def summary(self) -> dict:
        """Aggregate throughput + the share trajectory + decomposed
        latency percentiles (queue delay vs service time)."""
        if not self.records:
            return {"batches": 0}
        t = [r["t_step"] for r in self.records]
        out = {
            "batches": len(self.records),
            "rows_total": int(sum(r["rows_total"] for r in self.records)),
            "t_total_s": float(sum(t)),
            "rows_per_s_mean": float(np.mean([r["rows_per_s"]
                                              for r in self.records])),
            "t_step_last": float(t[-1]),
            "shares_final": [float(s) for s in self.scheduler.shares],
            "live_final": [bool(x) for x in self.scheduler.live],
            "failures": sum(len(r["failures"]) for r in self.records),
        }
        if self.guard is not None:
            out["guard_trips"] = self.guard.switch.n_trips
            out["guard_tripped"] = self.guard.tripped
        if self._obs is not None and self._h_batch.count:
            # bucket-estimated tail latencies, decomposed: service time
            # (one scheduler step; t_step_p* kept as the legacy alias)
            # vs queue delay (waiting before dispatch)
            for q, tag in ((0.50, "p50"), (0.95, "p95"), (0.99, "p99")):
                est = self._h_batch.percentile(q)
                out[f"t_step_{tag}"] = est
                out[f"service_{tag}"] = est
                out[f"queue_delay_{tag}"] = self._h_queue.percentile(q)
        return out
