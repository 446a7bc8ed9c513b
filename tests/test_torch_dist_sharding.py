"""The port's sharding rules and spec derivation (``repro_torch.dist.
sharding``) against the reference's, on the same axis names and sizes.

The reference derives its specs on a ``jax.sharding.AbstractMesh`` (no
devices needed); the port on ``launch.mesh.make_production_mesh`` /
``dist.ranks.ShapeMesh``.  Parameter and optimizer trees are the port's
per-layer leaves (the real shapes of Qwen2.5-3B and Qwen2-MoE, built on
the meta device), handed to both packages.  Decode caches are the port's
4-D per-layer leaves against the reference's stacked 5-D ones: a port spec
must equal the reference's with its leading group entry dropped.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.dist import sharding as ref_sharding
from repro_torch import configs
from repro_torch.dist import api, sharding
from repro_torch.dist.ranks import ShapeMesh
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, init_opt_state

MESHES = {
    "data2_model4": ((2, 4), ("data", "model")),
    "pod2_data2_model4": ((2, 2, 4), ("pod", "data", "model")),
    "production": ((16, 16), ("data", "model")),
    "production_multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}
KV_SHARDS = ("heads", "batch_seq", "seq", "none")


def meshes(name):
    shape, axes = MESHES[name]
    return ShapeMesh(axes, shape), AbstractMesh(shape, axes)


def pair(**kw):
    return sharding.ShardingConfig(**kw), ref_sharding.ShardingConfig(**kw)


def sds(tree):
    """The port's shape tree as the reference's ShapeDtypeStructs."""
    if isinstance(tree, dict):
        return {k: sds(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [sds(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), jnp.float32)


def ref_tuples(tree):
    if isinstance(tree, dict):
        return {k: ref_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [ref_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("kv_shard", KV_SHARDS)
def test_rules_match_reference(mesh_name, kv_shard):
    mesh, ref_mesh = meshes(mesh_name)
    port, ref = pair(kv_shard=kv_shard, fsdp_axes=("data",),
                     expert_axes=("model",), seq_parallel=True)
    got, want = port.rules(mesh), ref.rules(ref_mesh)
    assert dict(got.rules) == dict(want.rules)
    assert port.batch_axes(mesh) == ref.batch_axes(ref_mesh)
    assert port.kv_seq_axes(mesh) == ref.kv_seq_axes(ref_mesh)
    for name in list(want.rules) + [None, "unknown"]:
        assert got.axes(name) == want.axes(name)
        assert got.axes_size(got.axes(name)) == want.axes_size(
            want.axes(name))
        for extent in (1, 3, 8, 12, 16, 48, 2048):
            assert got.spec_dim(name, extent) == want.spec_dim(name, extent)


def test_production_mesh_is_shape_only():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    mesh = make_production_mesh(shape=(4, 8), axes=("a", "b"))
    assert mesh.shape == {"a": 4, "b": 8}


# -- parameters and optimizer state ----------------------------------------------

SCFGS = {
    "tp": dict(model_axes=("model",)),
    "tp_fsdp": dict(model_axes=("model",), fsdp_axes=("data",)),
    # fsdp over the model axes too: an axis shards one dim of a leaf at most
    # (the reference's test_param_specs_tolerate_overlapping_axis_roles)
    "overlap": dict(model_axes=("model",), fsdp_axes=("model",)),
    "overlap_pod": dict(model_axes=("model",), fsdp_axes=("pod", "model")),
    "fsdp_pod_data": dict(model_axes=(), fsdp_axes=("pod", "data")),
}


@pytest.fixture(scope="module")
def real_params():
    """Each config's per-layer parameter shapes, first two layers and the
    rest (embedding, head, final norm)."""
    out = {}
    for arch in ("qwen2.5-3b", "qwen2-moe-a2.7b"):
        cfg = configs.get(arch)
        model = build_model(dataclasses.replace(
            cfg, n_layers=2, layer_kinds=cfg.layer_kinds[:2]), device="meta")
        out[arch] = dict(model.named_parameters())
    return out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("scfg_name", list(SCFGS))
@pytest.mark.parametrize("mesh_name", ["data2_model4", "pod2_data2_model4",
                                       "production"])
def test_param_specs_match_reference(real_params, arch, scfg_name,
                                     mesh_name):
    mesh, ref_mesh = meshes(mesh_name)
    port, ref = pair(**SCFGS[scfg_name])
    params = real_params[arch]
    got = sharding.param_specs(params, mesh, port)
    want = ref_tuples(ref_sharding.param_specs(sds(params), ref_mesh, ref))
    assert got == want
    for spec in got.values():           # an axis appears once in a spec
        axes = [a for e in spec if e for a in ((e,) if isinstance(e, str)
                                               else e)]
        assert len(axes) == len(set(axes))


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_opt_specs_match_reference(real_params, moments):
    mesh, ref_mesh = meshes("data2_model4")
    port, ref = pair(model_axes=("model",), fsdp_axes=("data",))
    params = {k: torch.empty(v.shape, dtype=torch.float32)
              for k, v in real_params["qwen2.5-3b"].items()
              if v.numel() < 2 ** 22}
    opt = init_opt_state(params, AdamWConfig(moments_dtype=moments))
    opt = {"m": opt["m"], "v": opt["v"]}
    got = sharding.opt_specs(opt, params, mesh, port)
    want = ref_tuples(ref_sharding.opt_specs(sds(opt), sds(params), ref_mesh,
                                             ref))
    assert got == want


# -- data batches and decode caches --------------------------------------------------

@pytest.mark.parametrize("mesh_name", ["data2_model4", "pod2_data2_model4"])
@pytest.mark.parametrize("kv_shard", KV_SHARDS)
@pytest.mark.parametrize("rows", [8, 6, 3])
def test_batch_specs_match_reference(mesh_name, kv_shard, rows):
    mesh, ref_mesh = meshes(mesh_name)
    port, ref = pair(kv_shard=kv_shard)
    batch = {"tokens": torch.empty(rows, 32), "labels": torch.empty(rows, 32),
             "patch_embeds": torch.empty(rows, 4, 16), "scalar": torch.empty(())}
    got = sharding.batch_specs(batch, mesh, port)
    want = ref_tuples(ref_sharding.batch_specs(sds(batch), ref_mesh, ref))
    assert got == want


def state_shapes(arch: str, batch: int, max_len: int) -> list:
    cfg = configs.get(arch).smoke()
    model = build_model(cfg, device="meta")
    return model.init_decode_state(batch, max_len)


@pytest.mark.parametrize("mesh_name", ["data2_model4", "pod2_data2_model4"])
@pytest.mark.parametrize("kv_shard", KV_SHARDS)
@pytest.mark.parametrize("arch, batch, max_len", [
    ("qwen2.5-3b", 8, 64), ("qwen2.5-3b", 6, 36),     # extents that divide
    ("qwen2.5-3b", 3, 30),                            # and ones that do not
    ("jamba-v0.1-52b", 8, 64), ("rwkv6-1.6b", 4, 16)])
def test_cache_specs_match_reference(mesh_name, kv_shard, arch, batch,
                                     max_len):
    mesh, ref_mesh = meshes(mesh_name)
    port, ref = pair(kv_shard=kv_shard)
    state = {"layers": state_shapes(arch, batch, max_len)}
    stacked = {"layers": [{k: jax.ShapeDtypeStruct((1, *v.shape), jnp.float32)
                           for k, v in layer.items()}
                          for layer in state["layers"]]}
    got = sharding.cache_specs(state, mesh, port)
    want = ref_sharding.cache_specs(stacked, ref_mesh, ref)
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w)
        for key in g:
            assert tuple(w[key])[0] is None
            assert g[key] == tuple(w[key])[1:], key


def test_constrain_resolves_through_mesh_rules():
    mesh, ref_mesh = meshes("data2_model4")
    port, _ = pair(kv_shard="batch_seq")
    rules = port.rules(mesh)
    seen = []

    class Recording(sharding.MeshRules):
        def place(self, x, dims):
            seen.append(dims)
            return super().place(x, dims)

    x = torch.zeros(8, 12, 6)
    with api.use_rules(Recording(mesh=mesh, rules=rules.rules)):
        assert api.constrain(x, "batch", "kv_seq", "heads") is x
        assert api.constrain(x, None, None, None) is x
    # batch over data (8 % 2), the sequence over model (12 % 4), heads
    # over model: 6 % 4 falls back to replication
    assert seen == [("data", "model", None)]
    assert api.constrain(x, "batch", None, None) is x     # no rules: identity


class CoordMesh:
    """A shape-only mesh seen from one coordinate: what a rank's
    ``ComputeLayout`` and ``leaf_layout`` read of a ``RankMesh``."""

    def __init__(self, axis_names, sizes, coords):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, sizes))
        self.coords = dict(zip(axis_names, coords))

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes) -> int:
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def _indices(rng) -> np.ndarray:
    """The indices of a region's range (a slice or a tuple of them)."""
    parts = (rng,) if isinstance(rng, slice) else rng
    return np.concatenate([np.arange(r.start, r.stop) for r in parts])


@pytest.mark.parametrize("arch, scfg_kw, serving", [
    ("qwen2.5-3b", dict(model_axes=("model",)), False),
    ("qwen2-moe-a2.7b", dict(model_axes=(), expert_axes=("model",)), False),
    ("qwen2.5-3b", dict(model_axes=(), fsdp_axes=("model",)), False),
    ("qwen2.5-3b", dict(model_axes=(), fsdp_axes=("data",)), False),
    ("qwen2.5-3b", dict(model_axes=("model",), kv_shard="batch_seq"), True),
    ("qwen2.5-3b", dict(model_axes=("model",), kv_shard="seq"), True),
    ("jamba-v0.1-52b", dict(model_axes=("model",)), False),
    ("rwkv6-1.6b", dict(model_axes=("model",)), False),
    ("rwkv6-1.6b", dict(model_axes=("model",)), True),
    ("jamba-v0.1-52b", dict(model_axes=("model",), mamba_tp=True), False),
    ("whisper-base", dict(model_axes=("model",)), False),
    ("whisper-base", dict(model_axes=(), fsdp_axes=("model",)), False),
    ("whisper-base", dict(model_axes=(), fsdp_axes=("data",)), False),
    ("qwen2.5-3b", dict(model_axes=("model",), grad_compression="int8"),
     False),
])
def test_every_layout_tiles_its_leaves(arch, scfg_kw, serving):
    """Every layout ``ShardingConfig`` derives runs in the port (RWKV-6's
    heads, Jamba's channels under ``mamba_tp``, an encoder-decoder under
    model or FSDP axes among them).  On a (2, 2) mesh, over the four
    ranks of the meta model: the storage blocks (``param_specs``; whole
    while serving) and the compute regions (``compute_region``) of each
    leaf cover every element equally often, and where a rank stores what
    it computes with nothing is gathered."""
    names, sizes = ("data", "model"), (2, 2)
    scfg = sharding.ShardingConfig(**scfg_kw)
    model = build_model(configs.get(arch).smoke(), device="meta")
    params = dict(model.named_parameters())
    store = {n: np.zeros(p.shape, int) for n, p in params.items()}
    comp = {n: np.zeros(p.shape, int) for n, p in params.items()}
    split = 0
    for coords in itertools.product(*(range(n) for n in sizes)):
        mesh = CoordMesh(names, sizes, coords)
        cl = sharding.ComputeLayout(scfg.rules(mesh))
        specs = ({n: (None,) * p.dim() for n, p in params.items()}
                 if serving else sharding.param_specs(params, mesh, scfg))
        for n, p in params.items():
            shape = tuple(p.shape)
            lay = sharding.leaf_layout(
                shape, specs[n], model.compute_region(n, shape, cl), mesh,
                cl.batch_axes)
            store[n][lay.block] += 1
            comp[n][np.ix_(*(_indices(r) for r in lay.region))] += 1
            split += any(r != slice(0, e) for r, e in zip(lay.region, shape))
            if lay.block == lay.region:
                assert not any(k == "gather" for k, *_ in lay.steps), n
    for n in params:
        for cover in (store[n], comp[n]):
            assert cover.min() >= 1 and cover.min() == cover.max(), n
    assert split or not (scfg.model_axes or scfg.expert_axes), arch
