"""Tensor parallelism and FSDP parameter sharding over CPU ranks (the
port's A6b), held against the reference.

* the twin of the reference's ``tests/test_distributed.py::
  test_tensor_parallel_train_step``: phi3.5-moe smoke on a (2, 4) mesh of
  8 ranks, FSDP over data, 2 microbatches, ``seq_parallel``, remat; its
  losses against the reference's one-device ``train_loop``;
* one sharded ``loss_and_grads`` of Qwen2.5-3B on (1, 4) (the model axis:
  KV 2 < 4) and on (2, 2) with FSDP over data: every gradient leaf,
  gathered whole, against ``jax.value_and_grad`` of the reference's loss
  on the whole batch, and each rank's stored blocks against the
  reference's leaf sliced by the reference's own ``param_specs``
  (Qwen2-MoE with its experts split and Jamba: ``test_torch_dist_ep_fsdp``,
  through the helpers here);
* the collectives a layer issues.

Float32 compute; the weights are the port's from seed 0, carried into the
reference's tree (the twin: the reference's own, which its ``train_loop``
draws, carried into the port), handed to the ranks as a ``state_dict`` (a
rank never imports jax).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as ref_configs
from repro.dist import sharding as ref_sharding
from repro.dist.sharding import ShardingConfig as RefShardingConfig
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.launch.train import train_loop as ref_train_loop
from repro.models import LM as RefLM
from repro.models import EncDec as RefEncDec
from repro_torch import configs
from repro_torch.convert import (_reference_leaf, encdec_from_jax_params,
                                 lm_from_jax_params)
from repro_torch.models import build_model
from helpers_dist import grads_rank, load_ranks, run_ranks, train_rank

LAYOUTS = {
    "model4": ((1, 4), dict(model_axes=("model",))),
    "data2_model2_fsdp": ((2, 2), dict(model_axes=("model",),
                                       fsdp_axes=("data",))),
    "model4_experts": ((1, 4), dict(model_axes=("model",),
                                    expert_axes=("model",))),
    "data2_model2_fsdp_experts": ((2, 2), dict(
        model_axes=("model",), fsdp_axes=("data",), expert_axes=("model",))),
}
B, T = 4, 16
S_ENC = 12                  # an encoder-decoder's frames a row


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread in this process while its tests run, as every rank has
    (``test_torch_dist_train``'s reason: under pytest-xdist the workers
    share the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def cfgs(arch: str):
    """Float32 smoke configs; Jamba cut to its first 5 layers (4 mamba, 2
    of them with experts, then its first attention layer): every kind of
    its period, at half the reference's compile time."""
    out = []
    for cfg in (configs.get(arch).smoke(), ref_configs.get(arch).smoke()):
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        if arch.startswith("jamba"):
            cfg = dataclasses.replace(cfg, n_layers=5,
                                      layer_kinds=cfg.layer_kinds[:5])
        out.append(cfg)
    return tuple(out)


_WEIGHTS: dict = {}


def reference_tree(model, rcfg) -> dict:
    """``model``'s parameters as the reference's tree (numpy leaves): the
    inverse of ``lm_from_jax_params``, each layer's leaf written into
    entry ``g`` of its scan slot's stacked leaf."""
    shapes = jax.eval_shape(RefLM(rcfg).init, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    slots = len(rcfg.group_pattern)
    for name, p in model.named_parameters():
        parts = name.split(".")
        node, index = tree, None
        if parts[0] == "layers":
            index, slot = divmod(int(parts[1]), slots)
            node, parts = tree["layers"][f"slot{slot}"], parts[2:]
        for key in parts[:-1]:
            node = node[key]
        if index is None:
            node[parts[-1]] = p.detach().numpy().copy()
        else:
            node[parts[-1]][index] = p.detach().numpy()
    return tree


def ref_model(rcfg):
    return (RefEncDec if rcfg.encdec else RefLM)(rcfg)


def reference(arch: str, tmp_path_factory, init: bool = False):
    """(reference params, port model, path of its saved state_dict): the
    port's weights from seed 0 carried into the reference's tree, or with
    ``init`` (always for an encoder-decoder) the reference's own (its
    jitted ``init``, as its ``train_loop`` draws them) carried into the
    port."""
    cfg, rcfg = cfgs(arch)
    init = init or cfg.encdec
    key = (arch, init)
    if key not in _WEIGHTS:
        if init:
            params = jax.jit(ref_model(rcfg).init)(jax.random.PRNGKey(0))
            convert = (encdec_from_jax_params if cfg.encdec
                       else lm_from_jax_params)
            model = convert(jax.tree.map(np.asarray, params), cfg, "cpu")
        else:
            model = build_model(cfg, seed=0, device="cpu")
            params = reference_tree(model, rcfg)
        path = tmp_path_factory.mktemp(f"w_{arch}") / "weights.pt"
        torch.save(model.state_dict(), path)
        _WEIGHTS[key] = (params, model, path)
    return _WEIGHTS[key]


def np_batch(cfg, seed: int = 1) -> dict:
    """Tokens and labels (B, T); an encoder-decoder's frames too."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1))
    out = {"tokens": toks[:, :-1].astype(np.int32),
           "labels": toks[:, 1:].astype(np.int32)}
    if cfg.encdec:
        out["frame_embeds"] = (rng.standard_normal((B, S_ENC, cfg.d_model))
                               * 0.02).astype(np.float32)
    return out


def torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
            else torch.as_tensor(v) for k, v in batch.items()}


_RUNS: dict = {}


def grad_jobs(todo, tmp, tmp_path_factory) -> list:
    """``grads_rank``'s jobs for the ``(arch, layout)`` cases ``todo``."""
    jobs = []
    for a, lay in todo:
        cfg, _ = cfgs(a)
        _, _, weights = reference(a, tmp_path_factory)
        batch = tmp / f"{a}_{lay}_batch.pt"
        torch.save(torch_batch(np_batch(cfg)), batch)
        jobs.append((f"{a}_{lay}", cfg,
                     dict(data_axes=("data",), **LAYOUTS[lay][1]),
                     str(weights), str(batch)))
    return jobs


def sharded_run(arch, layout, tmp_path_factory, cases, spawn=None):
    """The ranks' saved loss, gradients and blocks of one case.  The first
    request runs every case of ``cases`` on the same mesh shape in one
    spawn of ranks (a spawn's start costs more than a smoke step);
    ``spawn(shape, jobs, tmp)`` runs the spawn where the caller adds work
    of its own to it."""
    if (arch, layout) not in _RUNS:
        shape = LAYOUTS[layout][0]
        world = int(np.prod(shape))
        todo = [c for c in cases if LAYOUTS[c[1]][0] == shape
                and c not in _RUNS]
        tmp = tmp_path_factory.mktemp("grads")
        jobs = grad_jobs(todo, tmp, tmp_path_factory)
        if spawn is None:
            run_ranks(grads_rank, world, tmp, shape=shape,
                      axes=("data", "model"), args=(jobs, str(tmp)),
                      timeout=120)
        else:
            spawn(shape, jobs, tmp)
        for (a, lay), job in zip(todo, jobs):
            _RUNS[(a, lay)] = (job[2], load_ranks(tmp, world, job[0]))
    return _RUNS[(arch, layout)]


_REF_GRADS: dict = {}


def leaf_kind(name: str) -> str:
    """A parameter's name with its layer index dropped."""
    return ".".join(p for p in name.split(".") if not p.isdigit())


def reference_grads(arch, tmp_path_factory):
    if arch not in _REF_GRADS:
        cfg, rcfg = cfgs(arch)
        params, model, _ = reference(arch, tmp_path_factory)
        batch = np_batch(cfg)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: ref_model(rcfg).loss(p, b), has_aux=True))(
                params, {k: jnp.asarray(v) for k, v in batch.items()})
        # the one-process port's own distance from them, leaf by leaf
        one = model
        one.zero_grad(set_to_none=True)
        got, _ = one.loss(torch_batch(batch))
        got.backward()
        grads = jax.tree.map(np.asarray, grads)
        gap: dict = {}
        for name, p in one.named_parameters():
            want = _reference_leaf(grads, name, cfg)
            kind = leaf_kind(name)
            gap[kind] = max(gap.get(kind, 0.0), float(
                np.abs(p.grad.numpy() - want).max()
                / max(np.abs(want).max(), 1e-30)))
        one.zero_grad(set_to_none=True)
        _REF_GRADS[arch] = (float(loss), grads, gap)
    return _REF_GRADS[arch]


def check_gradients(arch, layout, tmp_path_factory, cases, spawn=None):
    """Each leaf's gradient, gathered whole, within 2e-6 of the leaf's
    largest reference entry, or within twice the one-process port's own
    largest distance over the leaves of that name where that is larger
    (float32 reductions in another order: Jamba's recurrences, whose
    one-process gradients lie up to ~1e-5 from the reference's); the loss
    within 1e-6 of it, relative."""
    cfg, _ = cfgs(arch)
    want_loss, want, gap = reference_grads(arch, tmp_path_factory)
    _, ranks = sharded_run(arch, layout, tmp_path_factory, cases, spawn)
    for r in ranks:
        assert abs(r["loss"] - want_loss) <= 1e-6 * abs(want_loss)
    for name, g in ranks[0]["grads"].items():
        ref = _reference_leaf(want, name, cfg)
        tol = max(2e-6, 2 * gap[leaf_kind(name)]) * max(np.abs(ref).max(),
                                                        1e-30)
        assert np.abs(g.numpy() - ref).max() <= tol, name


def check_blocks(arch, layout, tmp_path_factory, cases, spawn=None):
    """Each rank stores the reference's leaf sliced by the reference's own
    ``param_specs`` for it (the per-layer leaf's shape on the same axis
    names and sizes); together the distinct blocks make every leaf."""
    cfg, _ = cfgs(arch)
    params, _, _ = reference(arch, tmp_path_factory)
    scfg_kw, ranks = sharded_run(arch, layout, tmp_path_factory, cases,
                                 spawn)
    shape, _ = LAYOUTS[layout]
    names = ("data", "model")
    ref_mesh = AbstractMesh(shape, names)
    numpy_params = jax.tree.map(np.asarray, params)
    leaves = {n: _reference_leaf(numpy_params, n, cfg)
              for n in ranks[0]["blocks"]}
    specs = ref_sharding.param_specs(
        {n: jax.ShapeDtypeStruct(v.shape, jnp.float32)
         for n, v in leaves.items()}, ref_mesh, RefShardingConfig(**scfg_kw))
    covered = {n: np.zeros(v.shape, bool) for n, v in leaves.items()}
    for rank, r in enumerate(ranks):
        coord = dict(zip(names, divmod(rank, shape[1])))
        for name, block in r["blocks"].items():
            index = []
            for extent, entry in zip(leaves[name].shape, tuple(specs[name])):
                axes = () if entry is None else (
                    (entry,) if isinstance(entry, str) else entry)
                i, n = 0, 1
                for a in axes:
                    i = i * shape[names.index(a)] + coord[a]
                    n *= shape[names.index(a)]
                per = extent // n
                index.append(slice(i * per, (i + 1) * per))
            want = leaves[name][tuple(index)]
            assert block.shape == want.shape, name
            np.testing.assert_array_equal(block.numpy(), want, err_msg=name)
            covered[name][tuple(index)] = True
    assert all(c.all() for c in covered.values())


CASES = [("qwen2.5-3b", "model4"), ("qwen2.5-3b", "data2_model2_fsdp")]


@pytest.mark.parametrize("arch, layout", CASES)
def test_sharded_gradients_match_reference(arch, layout, tmp_path_factory):
    check_gradients(arch, layout, tmp_path_factory, CASES)


@pytest.mark.parametrize("arch, layout", CASES)
def test_stored_blocks_are_reference_leaves_sliced(arch, layout,
                                                   tmp_path_factory):
    check_blocks(arch, layout, tmp_path_factory, CASES)


def test_collectives_a_layer_issues(tmp_path_factory):
    """Qwen2.5-3B over the model axis (1, 4), no ``seq_parallel``: two
    all-reduces a layer forward and two backward, the embedding's sum and
    its transpose, and the vocab-parallel cross-entropy's max, sum of
    exponentials and target logit (the sums transposed in the backward);
    every leaf gathered once on use and scattered once, except where its
    storage block is its compute block (the vocab rows of the tied table,
    the MLP's ``ff`` columns: ``param_specs`` splits the same dimension
    over the same axes)."""
    cfg, _ = cfgs("qwen2.5-3b")
    _, ranks = sharded_run("qwen2.5-3b", "model4", tmp_path_factory, CASES)
    chunks = T // min(cfg.logit_chunk, T)
    for r in ranks:
        counts = r["counts"]
        assert counts["all_reduce_sum@model"]["calls"] == (
            2 + 4 * cfg.n_layers + 4 * chunks)
        assert counts["all_reduce_max@model"]["calls"] == chunks
        gathers = counts["all_gather@model"]["calls"]
        assert gathers == counts["reduce_scatter@model"]["calls"]
        aligned = 1 + 3 * cfg.n_layers
        assert gathers == len(r["blocks"]) - aligned
        assert set(counts) == {"all_reduce_sum@model", "all_reduce_max@model",
                               "all_gather@model", "reduce_scatter@model"}


# -- the twin of the reference's test_tensor_parallel_train_step ------------

TP_TRAIN = dict(steps_total=4, batch=4, seq_len=32)
TP_SCFG = dict(data_axes=("data",), model_axes=("model",),
               fsdp_axes=("data",), microbatches=2, seq_parallel=True,
               remat=True)


def test_tensor_parallel_train_step(tmp_path_factory):
    arch = "phi3.5-moe-42b-a6.6b"
    cfg, rcfg = cfgs(arch)
    _, _, weights = reference(arch, tmp_path_factory, init=True)
    tmp = tmp_path_factory.mktemp("tp_train")
    run_ranks(train_rank, 8, tmp, shape=(2, 4), axes=("data", "model"),
              args=(cfg, TP_TRAIN, TP_SCFG, str(tmp), str(weights)),
              timeout=120)
    ranks = load_ranks(tmp, 8)
    want = ref_train_loop(rcfg, mesh=ref_host_mesh(1, ("data",)),
                          log_every=0, scfg=RefShardingConfig(**TP_SCFG),
                          **TP_TRAIN)["losses"]
    for r in ranks:
        losses = r["losses"]
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0] + 0.5
        np.testing.assert_allclose(losses, want, rtol=2e-4, atol=2e-4)
