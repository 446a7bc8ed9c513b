"""Deterministic, resumable, host-sharded synthetic data pipeline.

A copy of the reference's ``data/pipeline.py`` (numpy only): the same
``(seed, step, process slice)`` gives byte-identical batches in both
packages.

Every batch is a pure function of ``(seed, step, process slice)``: resuming
from a checkpoint at step k reproduces the exact token stream without any
persisted cursor beyond the step counter — the property the fault-
tolerance tests assert (bitwise-identical restart).

The stream has learnable structure (an affine token chain with noise) so
end-to-end training demonstrably reduces loss; pure-uniform tokens would
make the e2e example meaningless.

Multi-host: each process materialises only its ``[lo, hi)`` row slice of
the global batch (``process_index/process_count`` or explicit overrides).
Batches are numpy arrays on the host; the trainer moves them to its
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

__all__ = ["DataConfig", "SyntheticPipeline"]


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: float = 0.8      # P(next token follows the affine chain)
    frontend: str = "tokens"    # mirror of ArchConfig.frontend
    d_model: int = 0            # for stub frontends
    n_patches: int = 0
    decoder_len: int = 0


class SyntheticPipeline:
    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        self.cfg = cfg
        if cfg.global_batch % process_count:
            raise ValueError("global_batch must divide across processes")
        per = cfg.global_batch // process_count
        self.lo = process_index * per
        self.hi = self.lo + per

    # -- pure batch functions -------------------------------------------------
    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rows = self.hi - self.lo
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.lo]))
        v = cfg.vocab_size
        a = 6364136223846793005 % v or 1
        seq_len = cfg.seq_len if cfg.frontend != "stub_frames" \
            else cfg.decoder_len
        toks = np.empty((rows, seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, rows)
        noise = rng.random((rows, seq_len)) > cfg.structure
        rand = rng.integers(0, v, (rows, seq_len))
        for t in range(seq_len):
            chain = (toks[:, t] * a + 12345) % v
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], chain)
        batch = {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
        if cfg.frontend == "stub_patches":
            batch["patch_embeds"] = rng.standard_normal(
                (rows, cfg.n_patches, cfg.d_model), np.float32) * 0.02
        if cfg.frontend == "stub_frames":
            batch["frame_embeds"] = rng.standard_normal(
                (rows, cfg.seq_len, cfg.d_model), np.float32) * 0.02
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[tuple[int, dict]]:
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1
