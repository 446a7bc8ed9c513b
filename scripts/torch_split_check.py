#!/usr/bin/env python3
"""``chip_smoke.device_split`` against the profiler's ``key_averages()``
on one profile.

    python3 scripts/torch_split_check.py

Qwen2.5-3B at full size takes two AdamW steps (``train_loop``, float32
parameters, bf16 compute, 2 x 2048, remat), then one more ``train_step``
twice under ``chip_smoke.device_split``, which reads the trace's raw
events.  The same profile is then read through ``key_averages()``, as
``device_split`` read it before: each kind's device ms, the launches and
the ``adamw`` range's device ms; beside them how many host events share
a correlation id, and the range's ms if a kernel counted for each of
them.  Prints one JSON line a repeat, with both readers' seconds.  Needs
one CUDA device.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)          # puts src/ on sys.path
    import torch.profiler as tp

    from repro_torch import _build
    from repro_torch.launch.steps import train_step
    from repro_torch.launch.train import train_loop
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine

    captured = {}

    class Kept(tp.profile):
        def __exit__(self, *exc):
            out = super().__exit__(*exc)
            captured["prof"] = self
            return out

    tp.profile = Kept                    # device_split imports it late

    def by_key_averages(prof) -> dict:
        split, adamw_ms, launches = {}, None, 0
        for evt in prof.key_averages():
            on_card = "cuda" in str(evt.device_type).lower()
            if evt.key == "adamw":
                if not on_card:
                    adamw_ms = cs.device_time_us(evt, total=True) / 1e3
                continue
            us = cs.device_time_us(evt)
            if on_card and us > 0:
                kind = cs.kernel_kind(evt.key)
                split[kind] = split.get(kind, 0.0) + us / 1e3
                launches += evt.count
        return {"split_ms": split, "adamw_ms": adamw_ms,
                "device_launches": launches}

    def shared_ids(prof) -> dict:
        """Host events (not launched by another) that share a correlation
        id, and the ``adamw`` range's device ms when a kernel counts for
        every host event with its linked id that starts inside the range
        (as the profiler's parse links them) instead of for one."""
        from torch.autograd import DeviceType

        events = prof.profiler.kineto_results.events()
        by_id: dict = {}
        spans = []
        for evt in events:
            if evt.device_type() != DeviceType.CPU:
                continue
            if evt.name() == "adamw":
                spans.append((evt.start_thread_id(), evt.start_ns(),
                              evt.end_ns()))
            elif evt.linked_correlation_id() == 0:
                by_id.setdefault(evt.correlation_id(), []).append(
                    (evt.start_thread_id(), evt.start_ns(), evt.name()))
        shared = {i: hosts for i, hosts in by_id.items() if len(hosts) > 1}
        all_links = 0.0
        for evt in events:
            if evt.device_type() == DeviceType.CPU or evt.name() == "adamw":
                continue
            for tid, t, _ in by_id.get(evt.linked_correlation_id(), ()):
                if any(tid == s_tid and lo <= t <= hi
                       for s_tid, lo, hi in spans):
                    all_links += evt.duration_ns() / 1e6
        return {"host_ids_shared": len(shared),
                "shared_examples": [sorted({h[2] for h in hosts})
                                    for hosts in list(shared.values())[:5]],
                "adamw_ms_every_link": all_links}

    _build.load_libraries(("flash_attention", "flash_attention_bwd"))
    cfg = cs.decoder_cfg(cs.LM_ARCH)
    model = build_model(cfg, seed=0)
    out = train_loop(cfg, steps_total=2, batch=2, seq_len=2048, seed=0,
                     remat=True, log_every=0, model=model)
    batch = cs.train_batch(cfg, 0, 2)
    opt_cfg = AdamWConfig(learning_rate=warmup_cosine(3e-4, 20, 2))
    for repeat in range(2):
        t0 = time.perf_counter()
        raw = cs.device_split(lambda: train_step(
            model, out["state"]["opt"], batch, opt_cfg, remat=True))
        t1 = time.perf_counter()
        old = by_key_averages(captured["prof"])
        t2 = time.perf_counter()
        print(json.dumps({
            "repeat": repeat, "raw_events_s": t1 - t0,
            "key_averages_s": t2 - t1,
            "raw_events": {k: raw[k] for k in ("split_ms", "device_launches",
                                               "device_busy_ms")},
            "key_averages": old,
            "links": shared_ids(captured["prof"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
