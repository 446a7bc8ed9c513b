"""The paper's method applied to the distribution config space of a model
on a production mesh.

The port of the reference's ``core/sharding_tuner.py``.  The system
configuration of a (model x workload x 256-rank mesh) — mesh
factorization, microbatch count, remat, FSDP, sequence parallelism, KV
layout — is a discrete space exactly like the paper's (threads,
affinity, fraction).  A *measurement* is the roofline of a point: mode
``"analytic"`` (the reference's) reckons it from the ledger and the
analytic collective bytes; mode ``"dryrun"`` (the reference's
``"compiled"``, which lowers and compiles the step) runs the step once on
meta tensors as rank 0 of a fake process group of the point's mesh
(``launch.dryrun``) and takes the collective bytes and the peak bytes a
rank from it — seconds a point, expensive enough that search-budget
reduction matters.  The *surrogate* is the same from-scratch BDTR over
encoded configs.  SAM / SAML / EM then transfer unchanged.

Objective: the roofline step-time bound max(compute, memory, collective)
for the H100 (``roofline.analysis.H100_SXM``) — the pod-level analogue of
E = max(T_host, T_device).
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np

from ..dist.sharding import ShardingConfig
from ..launch import dryrun, policies, shapes
from ..models.config import ArchConfig
from ..roofline import analysis
from ..tune import TuneResult, TuningSession
from .bdtr import BoostedTreesRegressor
from .space import ConfigSpace, Param

__all__ = ["ShardingTuner", "sharding_space", "evaluate_config"]


def sharding_space(cell: shapes.ShapeCell) -> ConfigSpace:
    """Discrete distribution-config space for one shape cell."""
    params = [
        Param("mesh_factor", ((8, 32), (16, 16), (32, 8), (64, 4))),
        Param("logit_chunk", (128, 256, 512)),
    ]
    if cell.kind == "train":
        params += [
            Param("microbatches", (1, 2, 4, 8, 16)),
            Param("remat", ("full", "save_dots", "none"), ordinal=False),
            Param("fsdp", (True, False), ordinal=False),
            Param("seq_parallel", (True, False), ordinal=False),
            Param("mamba_tp", (True, False), ordinal=False),
        ]
    else:
        params += [
            Param("kv_shard", ("heads", "batch_seq", "seq", "none"),
                  ordinal=False),
            Param("fsdp", (True, False), ordinal=False),
        ]
    return ConfigSpace(params)


def _to_scfg(point: dict, cell: shapes.ShapeCell) -> ShardingConfig:
    if cell.kind == "train":
        return ShardingConfig(
            data_axes=("data",), model_axes=("model",),
            fsdp_axes=("data",) if point["fsdp"] else (),
            microbatches=int(point["microbatches"]),
            remat=point["remat"] != "none",
            remat_policy=(point["remat"] if point["remat"] != "none"
                          else "full"),
            seq_parallel=bool(point["seq_parallel"]),
            mamba_tp=bool(point["mamba_tp"]),
        )
    return ShardingConfig(
        data_axes=("data",), model_axes=("model",),
        fsdp_axes=("data",) if point["fsdp"] else (),
        kv_shard=str(point["kv_shard"]),
        remat=False,
    )


def _valid(point: dict, cfg: ArchConfig, cell: shapes.ShapeCell) -> bool:
    d_axis = point["mesh_factor"][0]
    if cell.kind == "train":
        per = cell.global_batch // int(point["microbatches"])
        if per * int(point["microbatches"]) != cell.global_batch:
            return False
        if per % d_axis and d_axis % per:
            return False
    if cell.kind != "train" and point["kv_shard"] == "seq" \
            and cell.global_batch > 1:
        return False
    return True


def evaluate_config(arch_cfg: ArchConfig, cell: shapes.ShapeCell,
                    point: dict, *, mode: str = "analytic",
                    hw: analysis.HW = analysis.H100_SXM) -> dict:
    """One 'experiment': evaluate a distribution config point.

    mode="analytic": instant (ledger + analytic collectives).
    mode="dryrun": the step run once on meta tensors as rank 0 of the
    point's mesh (``launch.dryrun``): its collective census and peak
    bytes a rank (seconds a point).
    """
    if mode not in ("analytic", "dryrun"):
        raise ValueError(f"mode={mode!r}: 'analytic' or 'dryrun'")
    d, m = point["mesh_factor"]
    cfg = dataclasses.replace(
        policies.arch_for_cell(arch_cfg, cell),
        logit_chunk=int(point["logit_chunk"]))
    scfg = _to_scfg(point, cell)
    n_chips = d * m
    ledger = analysis.analytic_cost(cfg, cell, scfg, n_chips=n_chips)
    if mode == "analytic":
        coll = analysis.analytic_collective_bytes(cfg, cell, scfg,
                                                  n_chips=n_chips)
        peak_gb = None
        t_wall = 0.0
    else:
        t0 = time.time()
        with dryrun.fake_ranks((d, m), ("data", "model")) as mesh:
            rec = dryrun.measure(dryrun.build_bundle(
                cfg.name, cell, mesh, scfg, cfg=cfg), mesh)
        coll = rec["collectives"]["transfer_bytes_per_step"]
        peak_gb = rec["memory"]["peak_per_device_gb"]
        t_wall = time.time() - t0
    terms = analysis.roofline_terms(ledger, coll, n_chips, hw)
    # memory-capacity penalty: infeasible configs must lose the search
    hbm_cap = hw.hbm_gb * 1.0
    if peak_gb is not None and peak_gb > 2.5 * hbm_cap:
        terms["step_time_bound_s"] *= 10.0
    return {**terms, "peak_gb": peak_gb, "eval_seconds": t_wall,
            "collective_bytes": coll, "point": dict(point)}


@dataclass
class ShardingTuner:
    """EM / SAM / SAML over the distribution space of one (arch x cell)."""

    arch_cfg: ArchConfig
    cell: shapes.ShapeCell
    mode: str = "analytic"            # evaluator for 'measurements'
    history: list = field(default_factory=list)
    hw: analysis.HW = analysis.H100_SXM

    def __post_init__(self):
        self.space = sharding_space(self.cell)
        self._cache: dict[tuple, float] = {}
        self.n_measurements = 0

    def _energy(self, point: dict) -> float:
        key = tuple(point[n] for n in self.space.names)
        if key in self._cache:
            return self._cache[key]
        if not _valid(point, self.arch_cfg, self.cell):
            return 1e9
        rec = evaluate_config(self.arch_cfg, self.cell, point, mode=self.mode,
                              hw=self.hw)
        self.n_measurements += 1
        e = rec["step_time_bound_s"]
        self._cache[key] = e
        self.history.append(rec)
        return e

    def session(self, *, store=None, surrogate=None,
                **session_kw) -> TuningSession:
        """A ``repro_torch.tune.TuningSession`` over this cell's config space.

        The evaluator is the roofline measurement (``self._energy``,
        internally cached + validity-penalised); ``surrogate`` may be a
        plain ``point -> predicted bound`` callable (see
        :meth:`fit_surrogate`).  ``store`` caches results under the
        (arch, cell, mode) workload signature.
        """
        return TuningSession(
            self.space, evaluator=self._energy, surrogate=surrogate,
            store=store, workload=self._workload() if store is not None
            else None, **session_kw)

    def _workload(self) -> dict:
        return {"arch": self.arch_cfg.name, "cell": self.cell.name,
                "mode": self.mode}

    def fit_surrogate(self, *, train_samples: int = 40, seed: int = 0):
        """Sample+measure valid points and fit the BDTR surrogate.

        Returns a plain ``point -> predicted bound`` callable (invalid
        points score 1e9, as in the measurement path) usable as the
        ``surrogate=`` of a session — the sharding analogue of the
        paper's one-time training grid.
        """
        rng = np.random.default_rng(seed)
        X, y = [], []
        while len(y) < train_samples:
            point = self.space.random(rng)
            if not _valid(point, self.arch_cfg, self.cell):
                continue
            e = self._energy(point)
            X.append(self._encode(point))
            y.append(e)
        model = BoostedTreesRegressor(n_estimators=120, max_depth=4,
                                      seed=seed).fit(np.stack(X),
                                                     np.asarray(y))

        def predicted(point):
            if not _valid(point, self.arch_cfg, self.cell):
                return 1e9
            return float(model.predict(self._encode(point)[None, :])[0])

        return predicted

    def tune_sam(self, iterations: int = 60, seed: int = 0) -> TuneResult:
        """The paper's SAM over the distribution space (roofline energy)."""
        return self.session().run("sam", iterations=iterations, seed=seed)

    def tune_saml(self, *, train_samples: int = 40, iterations: int = 2000,
                  seed: int = 0) -> TuneResult:
        """Paper's SAML: sample+measure, fit BDTR, SA on the surrogate.

        The search runs on the fitted surrogate; the suggested
        configuration is then measured once (the session's ground-truth
        re-scoring — the paper's final check)."""
        surrogate = self.fit_surrogate(train_samples=train_samples,
                                       seed=seed)
        # the session's ground-truth re-scoring measures the suggested
        # config once through self._energy (the evaluator fallback)
        return self.session(surrogate=surrogate).run(
            "saml", iterations=iterations, seed=seed)

    def _encode(self, point: dict) -> np.ndarray:
        feats = []
        for p in self.space.params:
            v = point[p.name]
            if p.name == "mesh_factor":
                feats.extend([float(v[0]), float(v[1])])
            elif p.ordinal:
                feats.append(float(v))
            else:
                feats.extend([1.0 if v == val else 0.0 for val in p.values])
        return np.asarray(feats)

    def baseline(self) -> dict:
        """The static default policy's roofline (paper-faithful baseline)."""
        scfg = policies.default_sharding(self.arch_cfg, self.cell)
        point = {
            "mesh_factor": (16, 16),
            "logit_chunk": 256,
        }
        if self.cell.kind == "train":
            point.update(microbatches=scfg.microbatches,
                         remat="full" if scfg.remat else "none",
                         fsdp=bool(scfg.fsdp_axes),
                         seq_parallel=scfg.seq_parallel,
                         mamba_tp=scfg.mamba_tp)
        else:
            point.update(kv_shard=scfg.kv_shard, fsdp=bool(scfg.fsdp_axes))
        return evaluate_config(self.arch_cfg, self.cell, point,
                               mode=self.mode, hw=self.hw)
