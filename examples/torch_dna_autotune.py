"""DNA-workload autotuning through the PyTorch port: the paper's full
experiment + a real-measured run (the twin of ``examples/dna_autotune.py``).

Default: reproduce the paper's SAML-vs-EM comparison for all four DNA
datasets on the calibrated Emil simulator (Tables VI-IX), on the host,
with the reference's output line for line.

--real: the same method with REAL measurements on the card — tune the
chunk of the DNA matcher (``fa_match``: the state-map kernel, the
associative compose, the count kernel) on 4,000,000 symbols, each
measurement a warm call then one timed between CUDA events, then verify
that SAM gets near the enumerated optimum with a fraction of the
measurements.  On an NVIDIA H100 80GB HBM3 at 700 W a measurement
reads 1.1–2.4 ms, EM's best ~1.15 ms (PERF.md, phase
``example_dna_real``).

    PYTHONPATH=src python examples/torch_dna_autotune.py [--real] \
        [--device cpu]
"""

import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np

CHUNKS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)


def simulated() -> None:
    from repro_torch.core import (DATASETS_GB, EmilPlatformModel,
                                  fit_emil_surrogates, paper_space)
    from repro_torch.tune import TuningSession
    platform = EmilPlatformModel()
    print("=== SAML vs EM on the calibrated Emil simulator ===")
    for name, gb in DATASETS_GB.items():
        sur, n_train = fit_emil_surrogates(
            platform, gb, datasets_gb=list(DATASETS_GB.values()), seed=0)
        rng = np.random.default_rng(0)
        session = TuningSession(
            paper_space(workload_step=3),
            evaluator=lambda c: platform.energy(c, gb, rng),
            truth=lambda c: platform.energy(c, gb, None),
            surrogate=sur, n_training_experiments=n_train)
        em = session.run("em")
        saml = session.run("saml", iterations=2000, seed=7,
                           checkpoints=(250, 500, 1000, 2000))
        print(f"\n{name} ({gb} GB): EM best {em.best_energy_measured:.3f}s "
              f"({em.n_experiments} experiments)")
        for it in (250, 500, 1000, 2000):
            e, cfg = saml.checkpoints[it]
            pct = 100 * (e - em.best_energy_measured) / em.best_energy_measured
            print(f"  SAML@{it:<5d} {e:.3f}s  (+{pct:5.2f}%)  "
                  f"split {cfg['host_fraction']}/{100-cfg['host_fraction']}")


def real(device=None, n_symbols: int = 4_000_000) -> dict:
    """EM over every chunk, then SAM (5 iterations, seed 0), each
    measurement of ``fa_match`` on ``device`` (``None`` = the card: a
    warm call, then one between CUDA events; the CPU runs the kernels'
    plain versions, one call on the host clock).
    Returns both results and every measurement's chunk, count and
    seconds."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.core import ConfigSpace, Param
    from repro_torch.kernels.dna_automaton import ops as dna_ops
    from repro_torch.tune import TuningSession

    dev = resolve_device(device)
    print("=== real-measured autotune of the PyTorch DNA matcher ===")
    rng = np.random.default_rng(0)
    text = torch.as_tensor(rng.integers(0, 4, n_symbols).astype(np.uint8),
                           device=dev)
    table, accept = dna_ops.build_motif_dfa("ACGTACGT")
    space = ConfigSpace([Param("chunk", CHUNKS)])
    measured = []

    def measure(cfg):
        def run():
            return dna_ops.fa_match(text, table, accept, chunk=cfg["chunk"],
                                    device=dev)

        if dev.type == "cuda":
            run()                                 # warm
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            count = run()
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            count = run()
            seconds = time.perf_counter() - t0
        measured.append({"chunk": cfg["chunk"], "count": int(count),
                         "seconds": seconds})
        return seconds

    em = TuningSession(space, evaluator=measure).run("em")
    sam = TuningSession(space, evaluator=measure).run("sam",
                                                      iterations=5, seed=0)
    print(f"EM  best {em.best_energy_measured*1e3:7.1f} ms  "
          f"chunk={em.best_config['chunk']}  "
          f"({em.n_experiments} measurements)")
    print(f"SAM best {sam.best_energy_measured*1e3:7.1f} ms  "
          f"chunk={sam.best_config['chunk']}  "
          f"({sam.n_experiments} measurements)")
    return {"em": em, "sam": sam, "measurements": measured, "text": text,
            "table": table, "accept": accept}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true")
    ap.add_argument("--device", default=None,
                    help="--real: torch device (default: the card; 'cpu' "
                    "runs the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    return real(args.device) if args.real else simulated()


if __name__ == "__main__":
    main()
