"""The port's sharding tuner (``repro_torch.core.sharding_tuner``) against
the reference's, on the CPU.

* ``evaluate_config(mode="analytic")`` gives the reference's record at
  every point of the serving spaces and at 200 seeded points of the
  training space, for Qwen2.5-3B, Jamba and Qwen2-MoE, under the
  reference's chip constants (the port's ``HW`` built from them).
* SAML measures at most 5 % of the training space and lands within 5 % of
  the exhaustive search's bound (outcomes compared, never random
  streams).
* A ``"dryrun"`` point (the step on meta tensors under a fake process
  group of the point's mesh) agrees with ``"analytic"`` on the compute and
  memory terms, and measures a peak a rank.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import sharding_tuner as ref_tuner
from repro.launch import shapes as ref_shapes
from repro.roofline import analysis as ref_analysis
from repro_torch import configs
from repro_torch.core import sharding_tuner as tuner
from repro_torch.launch import shapes
from repro_torch.roofline import analysis

ARCHS = ("qwen2.5-3b", "jamba-v0.1-52b", "qwen2-moe-a2.7b")
V5E = ref_analysis.V5E
HW = analysis.HW(peak_flops=V5E.peak_flops, hbm_bw=V5E.hbm_bw,
                 link_bw=V5E.ici_bw, hbm_gb=V5E.hbm_gb)


def points(cell: str, n: int | None = None) -> list[dict]:
    """Every point of the cell's space, or ``n`` drawn from seed 0."""
    space = tuner.sharding_space(shapes.SHAPE_CELLS[cell])
    if n is None:
        return [dict(zip(space.names, vals)) for vals in itertools.product(
            *(p.values for p in space.params))]
    rng = np.random.default_rng(0)
    return [space.random(rng) for _ in range(n)]


def assert_records_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-12), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("cell", ["prefill_32k", "decode_32k", "train_4k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_evaluation_equals_the_references(arch, cell):
    cfg, rcfg = configs.get(arch), ref_configs.get(arch)
    c, rc = shapes.SHAPE_CELLS[cell], ref_shapes.SHAPE_CELLS[cell]
    pts = points(cell, 200 if cell == "train_4k" else None)
    assert len(pts) == (200 if cell == "train_4k" else 96)
    for point in pts:
        assert tuner._valid(point, cfg, c) == ref_tuner._valid(point, rcfg,
                                                                rc)
        assert_records_equal(
            tuner.evaluate_config(cfg, c, point, hw=HW),
            ref_tuner.evaluate_config(rcfg, rc, point))


@pytest.mark.parametrize("arch", ARCHS)
def test_saml_finds_the_exhaustive_bound_from_5_percent(arch):
    cfg, cell = configs.get(arch), shapes.SHAPE_CELLS["train_4k"]
    em = tuner.ShardingTuner(cfg, cell).session().run("em")
    tuned = tuner.ShardingTuner(cfg, cell)
    res = tuned.tune_saml(seed=0)
    assert tuned.n_measurements <= 0.05 * tuned.space.size()
    assert res.best_energy_measured <= 1.05 * em.best_energy_measured
    # the baseline policy is a point of the space, no better than EM's
    assert tuned.baseline()["step_time_bound_s"] >= \
        em.best_energy_measured


def test_dryrun_point_agrees_with_analytic():
    cfg, cell = configs.get("qwen2.5-3b"), shapes.SHAPE_CELLS["decode_32k"]
    point = {"mesh_factor": (16, 16), "logit_chunk": 256,
             "kv_shard": "batch_seq", "fsdp": True}
    fast = tuner.evaluate_config(cfg, cell, point)
    slow = tuner.evaluate_config(cfg, cell, point, mode="dryrun")
    for k in ("compute_s", "memory_s", "model_flops", "hlo_flops"):
        assert slow[k] == fast[k], k
    assert 0 < slow["peak_gb"] < analysis.H100_SXM.hbm_gb
    assert slow["collective_bytes"] > 0 and slow["eval_seconds"] > 0
    with pytest.raises(ValueError, match="mode"):
        tuner.evaluate_config(cfg, cell, point, mode="compiled")
