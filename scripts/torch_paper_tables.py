#!/usr/bin/env python3
"""The paper's figure and tables through the port: Fig. 2 and Tables 2, 4-9.

    PYTHONPATH=src python3 scripts/torch_paper_tables.py [--out PATH]
        [--tables fig2 table2 tables45 tables67 tables89] [--datasets cat]

One function per figure or table, each returning ``(rows, derived)``:
``rows`` are CSV-ready dicts and ``derived`` the headline number the paper
claims.  Everything runs on the host: the platform is the analytic
``EmilPlatformModel``, the surrogates are numpy BDTR fits, and the
searches are the scalar engines (the paper's single SA chain), so the
rows equal the JAX package's ``benchmarks/paper_tables.py`` row for row.
Tables 6-9 run the scalar SAML chain for 2000 iterations a dataset;
``--datasets`` cuts them to some of the four genomes (the surrogates are
still fit on all four).  Prints one line per table (name, seconds,
derived); ``--out`` also writes every row as JSON.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import (DATASETS_GB, EmilPlatformModel,  # noqa: E402
                              fit_emil_surrogates, paper_space,
                              percent_error)
from repro_torch.tune import TuningSession  # noqa: E402

CHECKPOINTS = (250, 500, 750, 1000, 1250, 1500, 1750, 2000)


def _normalize_1_10(values):
    v = np.asarray(values, float)
    lo, hi = v.min(), v.max()
    return 1 + 9 * (v - lo) / max(hi - lo, 1e-12)


def _datasets(names):
    return {n: DATASETS_GB[n] for n in (names or DATASETS_GB)}


def fig2_motivation(platform: EmilPlatformModel):
    """Fig. 2: execution time vs split ratio for 3 scenarios (normalized 1-10)."""
    scenarios = [
        ("exp1_190MB_48thr", 0.19, 48),
        ("exp2_3250MB_48thr", 3.25, 48),
        ("exp3_3250MB_4thr", 3.25, 4),
    ]
    rows = []
    best = {}
    for name, gb, threads in scenarios:
        fractions = list(range(0, 101, 10))
        times = [platform.energy({"host_threads": threads,
                                  "device_threads": 240,
                                  "host_affinity": "scatter",
                                  "device_affinity": "balanced",
                                  "host_fraction": f}, gb)
                 for f in fractions]
        norm = _normalize_1_10(times)
        best[name] = fractions[int(np.argmin(times))]
        for f, t, nv in zip(fractions, times, norm):
            rows.append({"scenario": name, "host_fraction": f,
                         "time_s": round(t, 4), "normalized": round(nv, 2)})
    # paper: exp1 -> host-only best; exp2 -> 60-70; exp3 -> device-heavy
    derived = (f"best_splits exp1={best['exp1_190MB_48thr']} "
               f"exp2={best['exp2_3250MB_48thr']} "
               f"exp3={best['exp3_3250MB_4thr']}")
    return rows, derived


def tables_4_5_prediction_accuracy(platform: EmilPlatformModel):
    """Tables IV-V (+Figs 5-8): BDTR accuracy per thread count + histograms."""
    sur, n_exp, ev = fit_emil_surrogates(
        platform, DATASETS_GB["human"],
        datasets_gb=list(DATASETS_GB.values()), return_eval=True, seed=0)
    rows = []
    headline = {}
    for side in ("host", "device"):
        X, y, yp = ev[side]
        threads = X[:, 1]
        for t in sorted(set(threads.tolist())):
            m = threads == t
            rows.append({
                "side": side, "threads": int(t),
                "absolute_s": round(float(np.abs(y[m] - yp[m]).mean()), 4),
                "percent": round(float(percent_error(y[m], yp[m]).mean()), 3),
                "n": int(m.sum()),
            })
        headline[side] = float(percent_error(y, yp).mean())
        # error histogram (Figs 7-8)
        hist, edges = np.histogram(np.abs(y - yp), bins=10)
        for h, e0, e1 in zip(hist, edges[:-1], edges[1:]):
            rows.append({"side": side + "_hist", "threads": -1,
                         "absolute_s": round(float(e0), 4),
                         "percent": round(float(e1), 4), "n": int(h)})
    derived = (f"avg_pct_err host={headline['host']:.2f}% "
               f"device={headline['device']:.2f}% "
               f"(paper: 5.24%/3.13%), n_experiments={n_exp}")
    return rows, derived


def _session_for(platform, dataset_gb, sur, n_train, step=3):
    space = paper_space(workload_step=step)
    rng = np.random.default_rng(0)
    return TuningSession(
        space,
        evaluator=lambda c: platform.energy(c, dataset_gb, rng),
        truth=lambda c: platform.energy(c, dataset_gb, None),
        surrogate=sur, n_training_experiments=n_train)


def tables_6_7_saml_vs_em(platform: EmilPlatformModel, datasets=None):
    """Tables VI-VII + Fig 9: SAML-vs-EM percent/absolute difference."""
    rows = []
    pct_at_1000 = []
    frac = None
    for name, gb in _datasets(datasets).items():
        sur, n_train = fit_emil_surrogates(
            platform, gb, datasets_gb=list(DATASETS_GB.values()), seed=0)
        tuner = _session_for(platform, gb, sur, n_train)
        em = tuner.run("em")
        saml = tuner.run("saml", iterations=2000, seed=7,
                         checkpoints=CHECKPOINTS)
        for it in CHECKPOINTS:
            e, _ = saml.checkpoints[it]
            pct = 100 * (e - em.best_energy_measured) / em.best_energy_measured
            rows.append({"dna": name, "iterations": it,
                         "percent_diff": round(pct, 3),
                         "absolute_diff_s": round(
                             e - em.best_energy_measured, 4)})
            if it == 1000:
                pct_at_1000.append(pct)
        frac = 1000 / em.space_size
    derived = (f"avg_pct_diff@1000={np.mean(pct_at_1000):.2f}% "
               f"(paper: 10.13%), search_budget={frac*100:.1f}% of EM "
               f"(paper: ~5%)")
    return rows, derived


def tables_8_9_speedup(platform: EmilPlatformModel, datasets=None):
    """Tables VIII-IX: tuned-config speedup vs host-only / device-only."""
    rows = []
    sp_host_1000, sp_dev_1000 = [], []
    for name, gb in _datasets(datasets).items():
        sur, n_train = fit_emil_surrogates(
            platform, gb, datasets_gb=list(DATASETS_GB.values()), seed=0)
        tuner = _session_for(platform, gb, sur, n_train)
        em = tuner.run("em")
        saml = tuner.run("saml", iterations=2000, seed=11,
                         checkpoints=CHECKPOINTS)
        t_host = platform.host_only_time(gb)
        t_dev = platform.device_only_time(gb)
        for it in CHECKPOINTS:
            e, _ = saml.checkpoints[it]
            rows.append({"dna": name, "config": str(it),
                         "speedup_vs_host": round(t_host / e, 2),
                         "speedup_vs_device": round(t_dev / e, 2)})
            if it == 1000:
                sp_host_1000.append(t_host / e)
                sp_dev_1000.append(t_dev / e)
        rows.append({"dna": name, "config": "EM",
                     "speedup_vs_host": round(
                         t_host / em.best_energy_measured, 2),
                     "speedup_vs_device": round(
                         t_dev / em.best_energy_measured, 2)})
    derived = (f"max_speedup@1000 vs_host={max(sp_host_1000):.2f}x "
               f"(paper 1.74x) vs_device={max(sp_dev_1000):.2f}x "
               f"(paper 2.18x)")
    return rows, derived


def table_2_strategy_costs(platform: EmilPlatformModel):
    """Table II: effort/accuracy accounting for EM / EML / SAM / SAML."""
    gb = DATASETS_GB["cat"]
    sur, n_train = fit_emil_surrogates(
        platform, gb, datasets_gb=list(DATASETS_GB.values()), seed=0)
    tuner = _session_for(platform, gb, sur, n_train, step=5)
    em = tuner.run("em")
    eml = tuner.run("eml")
    sam = tuner.run("sam", iterations=1000, seed=0)
    saml = tuner.run("saml", iterations=1000, seed=0)
    rows = []
    for rep in (em, eml, sam, saml):
        rows.append({
            "method": rep.strategy,
            "search_experiments": rep.n_experiments,
            "predictions": rep.n_predictions,
            "training_experiments": rep.n_training_experiments,
            "measured_best_s": round(rep.best_energy_measured, 4),
            "pct_vs_EM": round(100 * (rep.best_energy_measured
                                      - em.best_energy_measured)
                               / em.best_energy_measured, 2),
        })
    derived = (f"SAM/EM effort={sam.n_experiments}/{em.n_experiments}"
               f"={100*sam.n_experiments/em.n_experiments:.1f}%")
    return rows, derived


TABLES = {
    "fig2": fig2_motivation,
    "table2": table_2_strategy_costs,
    "tables45": tables_4_5_prediction_accuracy,
    "tables67": tables_6_7_saml_vs_em,
    "tables89": tables_8_9_speedup,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", nargs="+", choices=list(TABLES),
                    default=list(TABLES))
    ap.add_argument("--datasets", nargs="+", choices=list(DATASETS_GB),
                    default=None, help="genomes of Tables 6-9 (default all)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write every table's rows and headline as JSON")
    args = ap.parse_args(argv)
    platform = EmilPlatformModel()
    out = {}
    for name in args.tables:
        fn = TABLES[name]
        kw = ({"datasets": args.datasets}
              if name in ("tables67", "tables89") else {})
        t0 = time.perf_counter()
        rows, derived = fn(platform, **kw)
        seconds = time.perf_counter() - t0
        print(f"{name},{seconds:.3f},{derived}", flush=True)
        out[name] = {"rows": rows, "derived": derived, "seconds": seconds}
    if args.out:
        path = Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out, indent=1))
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
