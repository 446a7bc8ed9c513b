"""The port's production-mesh dry run (``repro_torch.launch.dryrun``) and
the serving layout it reckons, on the CPU.

* The reference's three integration cells (``tests/test_dryrun_integration
  .py``) run on meta tensors as rank 0 of a fake process group of the
  production mesh: each ``ok``, its peak a rank under the H100's 80 GB and
  its FLOPs above 0; ``batch_specs_for`` covers the same 32 cells with the
  reference's shapes and dtypes.
* The dry run's collectives are the run's: a smoke config's training and
  decode steps on two gloo CPU ranks (a (1, 2) mesh splitting the heads,
  a (2, 1) mesh storing the parameters FSDP over data) give the same
  ``COUNTERS``, by op, axes, calls and bytes, as the dry run of the same
  step under the fake group; its kernel census is the formula's (B3
  twice a layer, B5 once, under both remat policies).
* FSDP-stored serving (``serve_session`` under ``fsdp_axes``) on the
  (2, 1) ranks: each rank holds its storage blocks, serves the tokens of
  one process, and its logits lie within 1.5e-6 of each step's largest.

Ranks are spawned once a mesh shape (``tests/helpers_dist.py``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import shapes as ref_shapes
from repro_torch import configs
from repro_torch.dist.ranks import ShapeMesh
from repro_torch.dist.sharding import ShardingConfig, param_specs
from repro_torch.launch import dryrun, shapes, steps
from repro_torch.launch.serve import serve_session
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline.analysis import H100_SXM
from helpers_dist import (load_ranks, many_rank, run_ranks, step_batch,
                          step_counts_rank, tp_serve_rank)

ARCH = "qwen2.5-3b"
TRAIN = dict(batch=4, seq_len=16)
SERVE = dict(batch=2, max_len=16)
SESSION = dict(batch=2, prompt_len=8, gen=6, seed=0)
MESHES = {"tp": (1, 2), "fsdp": (2, 1)}
AXES = ("data", "model")
SCFGS = {
    "tp": {"train": dict(model_axes=("model",), seq_parallel=True,
                         remat=True),
           "serve": dict(model_axes=("model",), kv_shard="heads")},
    "fsdp": {"train": dict(model_axes=("model",), fsdp_axes=("data",),
                           remat=True, remat_policy="save_dots"),
             "serve": dict(model_axes=("model",), fsdp_axes=("data",),
                           kv_shard="none")},
}
SESSION_ARCHS = ("qwen2.5-3b", "whisper-base")


def smoke(arch: str = ARCH):
    return dataclasses.replace(configs.get(arch).smoke(),
                               compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the reference's cells ------------------------------------------------------

@pytest.mark.parametrize("arch,cell,mesh", [
    ("whisper-base", "prefill_32k", "single"),
    ("rwkv6-1.6b", "long_500k", "multi"),
    ("qwen2.5-3b", "decode_32k", "single"),
])
def test_dryrun_cell_runs(arch, cell, mesh):
    rec = dryrun.run_cell(arch, shapes.SHAPE_CELLS[cell], mesh)
    assert rec["ok"], rec.get("traceback")
    assert rec["n_devices"] == (512 if mesh == "multi" else 256)
    assert 0 < rec["memory"]["peak_bytes"] < H100_SXM.hbm_gb * 1e9
    assert rec["memory"]["param_bytes"] <= rec["memory"]["peak_bytes"]
    assert rec["flops"]["total"] > 0
    # a kernel ran on meta for every cell: no launch, a census entry
    assert rec["kernels"] and all(k["calls"] > 0
                                  for k in rec["kernels"].values())
    assert rec["collectives"]["weighted"] == {
        k: {f: float(v) for f, v in st.items()}
        for k, st in rec["collectives"]["raw"].items()}


def test_batch_specs_cover_all_cells():
    n = 0
    for name in configs.ARCH_NAMES:
        cfg, rcfg = configs.get(name), ref_configs.get(name)
        for cell in shapes.SHAPE_CELLS.values():
            ok, why = shapes.applicable(cfg, cell)
            assert (ok, why) == ref_shapes.applicable(
                rcfg, ref_shapes.SHAPE_CELLS[cell.name])
            if not ok:
                assert "quadratic" in why
                continue
            got = shapes.batch_specs_for(cfg, cell)
            want = ref_shapes.batch_specs_for(
                rcfg, ref_shapes.SHAPE_CELLS[cell.name])
            assert list(got) == list(want), (name, cell.name)
            for k, t in got.items():
                assert t.device.type == "meta"
                assert tuple(t.shape) == tuple(want[k].shape), (name, k)
                assert str(t.dtype).removeprefix("torch.") == str(
                    want[k].dtype), (name, k)
            n += 1
    assert n == 32, n


# -- the dry run's collectives are the run's ---------------------------------------

def step_jobs(mesh: str) -> list:
    cfg = smoke()
    return [(f"{mesh}_{kind}", kind, cfg,
             dict(data_axes=("data",), **SCFGS[mesh][kind]),
             TRAIN if kind == "train" else SERVE)
            for kind in ("train", "serve")]


def session_jobs(tmp) -> list:
    jobs = []
    for arch in SESSION_ARCHS:
        cfg = smoke(arch)
        path = tmp / f"{arch}.pt"
        torch.save(build_model(cfg, seed=0, device="cpu").state_dict(), path)
        jobs.append((f"session_{arch}", cfg, SESSION,
                     dict(data_axes=("data",), model_axes=("model",),
                          fsdp_axes=("data",), kv_shard="none"), str(path)))
    return jobs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's ranks, one spawn a mesh shape: the steps' counters on
    both, FSDP-stored sessions on (2, 1)."""
    out = {}
    for mesh, shape in MESHES.items():
        tmp = tmp_path_factory.mktemp(f"dryrun_{mesh}")
        parts = [(step_counts_rank, step_jobs(mesh))]
        if mesh == "fsdp":
            parts.append((tp_serve_rank, session_jobs(tmp)))
        run_ranks(many_rank, 2, tmp, shape=shape, axes=AXES,
                  args=(parts, str(tmp)), timeout=150)
        for _, jobs in parts:
            for job in jobs:
                out[job[0]] = load_ranks(tmp, 2, job[0])
    return out


def dry(mesh: str, kind: str) -> dict:
    cfg = smoke()
    scfg = ShardingConfig(data_axes=("data",), **SCFGS[mesh][kind])
    with dryrun.fake_ranks(MESHES[mesh], AXES) as m:
        if kind == "train":
            batch = {k: v.to("meta") for k, v in step_batch(
                cfg, TRAIN["batch"], TRAIN["seq_len"]).items()}
            bundle = steps.make_train_step(cfg, scfg, m, AdamWConfig(),
                                           batch)
        else:
            bundle = steps.make_serve_step(cfg, scfg, m, SERVE["batch"],
                                           SERVE["max_len"])
        return dryrun.measure(bundle, m)


def without_seconds(counts: dict) -> dict:
    return {k: {f: v for f, v in rec.items() if f != "seconds"}
            for k, rec in counts.items()}


@pytest.mark.parametrize("kind", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_dryrun_counters_equal_the_ranks(mesh, kind, ranks):
    rec = dry(mesh, kind)
    got = without_seconds(rec["counters"])
    assert got, "the step issued no collective"
    want = without_seconds(ranks[f"{mesh}_{kind}"][0]["counts"])
    assert got == want
    # the census applies the ring model to the same calls
    census = rec["collectives"]
    assert sum(v["count"] for v in census["raw"].values()) == sum(
        v["calls"] for v in got.values())
    assert census["transfer_bytes_per_step"] == pytest.approx(
        sum(census["by_key"].values()))


@pytest.mark.parametrize("remat", [True, "save_dots"])
def test_kernel_census_is_the_formulas(remat):
    """A training step launches B3 twice a layer (forward and the
    recompute of the attention core) and B5 once, under either policy;
    no launch counter moves."""
    from repro_torch.kernels.flash_attention import kernel as fak

    cfg = smoke()
    scfg = ShardingConfig(remat=bool(remat),
                          remat_policy="save_dots" if remat == "save_dots"
                          else "full")
    batch = {k: v.to("meta") for k, v in step_batch(
        cfg, TRAIN["batch"], TRAIN["seq_len"]).items()}
    before = (fak.flash_attention_fwd.launches,
              fak.flash_attention_bwd.launches)
    out = steps.make_train_step(cfg, scfg, None, AdamWConfig(),
                                batch).dry_run()
    n = sum(k == "attn" for k in cfg.layer_kinds)
    assert out["kernels"]["flash_attention_fwd"]["programs"] == {
        "fwd": 2 * n}
    assert out["kernels"]["flash_attention_bwd"]["programs"] == {
        "dq": n, "dkv": n}
    assert set(out["kernels"]) == {"flash_attention_fwd",
                                   "flash_attention_bwd"}
    assert (fak.flash_attention_fwd.launches,
            fak.flash_attention_bwd.launches) == before


# -- FSDP-stored serving -------------------------------------------------------------

@pytest.mark.parametrize("arch", SESSION_ARCHS)
def test_fsdp_stored_session_matches_one_process(arch, ranks):
    cfg = smoke(arch)
    one = serve_session(
        cfg, model=build_model(cfg, seed=0, device="cpu").cast_for_serving(),
        return_logits=True, **SESSION)
    mesh = ShapeMesh(AXES, MESHES["fsdp"])
    scfg = ShardingConfig(data_axes=("data",), model_axes=("model",),
                          fsdp_axes=("data",), kv_shard="none")
    whole = dict(build_model(cfg, device="meta").named_parameters())
    specs = param_specs(whole, mesh, scfg)
    per = SESSION["batch"] // 2
    for rank, r in enumerate(ranks[f"session_{arch}"]):
        np.testing.assert_array_equal(r["generated"], one["generated"])
        rows = slice(rank * per, (rank + 1) * per)
        for got, want in zip(r["logits"], one["logits"]):
            want = want[rows]
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1.5e-6 * float(want.abs().max()))
        # each rank holds its param_specs blocks: halves of the leaves
        # FSDP splits over data, and nothing more
        split = 0
        for name, p in whole.items():
            block = tuple(n // (2 if e == "data" else 1)
                          for n, e in zip(p.shape, specs[name]))
            assert r["shapes"][name] == block, name
            split += block != tuple(p.shape)
        assert split > len(whole) // 2
        resident = sum(math.prod(s) for s in r["shapes"].values())
        assert resident < sum(p.numel() for p in whole.values())


# -- the kernel wrappers on meta tensors ----------------------------------------------

def kernel_cases() -> dict:
    """(wrapper, its inputs on the CPU, the programs a call runs)."""
    from repro_torch.kernels.decode_attention import kernel as dak
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.mamba_scan import kernel as msk
    from repro_torch.kernels.rwkv6_wkv import kernel as wkk

    g = torch.Generator().manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=g)

    q, k, v, do = (rand(1, 40, 2, 32) for _ in range(4))
    o, lse = fak.flash_attention_fwd_plain(q, k, v, causal=True)
    x, dt = rand(1, 20, 8), rand(1, 20, 8).abs() * 0.1
    scan = (x, dt, -rand(8, 4).abs(), rand(1, 20, 4), rand(1, 20, 4),
            rand(8), rand(1, 8, 4))
    wkv = [rand(1, 70, 2, 16) for _ in range(3)] + [
        torch.sigmoid(rand(1, 70, 2, 16)), rand(2, 16), rand(1, 2, 16, 16)]
    return {
        "flash_attention_fwd": (fak.flash_attention_fwd, (q, k, v),
                                {"fwd": 1}),
        "flash_attention_bwd": (fak.flash_attention_bwd,
                                (q, k, v, o, lse, do), {"dq": 1, "dkv": 1}),
        "decode_attention": (
            lambda *a: dak.decode_attention(*a, 37, return_lse=True),
            (rand(1, 2, 2, 32), rand(1, 64, 2, 32), rand(1, 64, 2, 32)),
            {"decode": 1}),
        "selective_scan_fwd": (msk.selective_scan_fwd, scan, {"scan": 1}),
        "selective_scan_bwd": (msk.selective_scan_bwd,
                               scan + (rand(1, 20, 8), rand(1, 8, 4)),
                               {"summaries": 1, "carry": 1, "chunks": 1}),
        "wkv6_fwd": (wkk.wkv6_fwd, tuple(wkv),
                     {"states": 1, "chunks": 1}),
        "wkv6_fwd serial": (wkk.wkv6_fwd, tuple(
            t[:, :1] if t.dim() == 4 and t.shape[1] == 70 else t
            for t in wkv), {"serial": 1}),
        "wkv6_bwd": (wkk.wkv6_bwd, tuple(wkv) + (rand(1, 70, 2, 16),
                                                 rand(1, 2, 16, 16)),
                     {"scans": 1, "chunks": 1}),
    }


@pytest.mark.parametrize("name", list(kernel_cases()))
def test_every_kernel_wrapper_on_meta_is_shape_only(name):
    """A meta call returns what the CPU branch returns, as shapes and
    dtypes on meta, records itself in the census (its programs, the
    reckoned work) and launches nothing."""
    from repro_torch.kernels.census import CENSUS

    fn, args, programs = kernel_cases()[name]
    wrapper = name.split()[0]
    want = fn(*args)
    counter = getattr(fn, "launches", None)
    CENSUS.reset()
    got = fn(*(a.to("meta") for a in args))
    assert [(t.shape, t.dtype, t.device.type) for t in got] == [
        (t.shape, t.dtype, "meta") for t in want]
    rec = CENSUS.snapshot()
    CENSUS.reset()
    assert list(rec) == [wrapper]
    assert rec[wrapper]["calls"] == 1
    assert rec[wrapper]["programs"] == programs
    assert rec[wrapper]["flops"] > 0 and rec[wrapper]["bytes"] > 0
    assert getattr(fn, "launches", None) == counter
