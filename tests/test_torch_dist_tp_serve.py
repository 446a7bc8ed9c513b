"""Tensor-parallel serving over two CPU ranks (``serve_session(scfg=,
mesh=)`` on a (1, 2) mesh whose model axis splits the heads, the ``ff``
columns and the vocabulary) against the one-process session and the
reference's ``serve_session``: the same tokens, float32 logits within
1e-5 of each step's largest.

``kv_shard="heads"``: each rank projects and caches the kv heads its q
heads read; ``"none"``: the cache holds every kv head on both ranks, and
each rank's q heads read theirs from it.  Qwen2.5-3B (KV 2, H 4: one kv
head a rank) and phi3.5-moe (its experts replicated, the router and top-k
on every rank).  The weights are the reference's (``lm_from_jax_params``),
handed to the ranks as a ``state_dict``.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch.serve import serve_session as ref_serve_session
from repro.models import LM as RefLM
from repro_torch import configs
from repro_torch.convert import lm_from_jax_params
from repro_torch.launch.serve import serve_session
from helpers_dist import load_ranks, run_ranks, tp_serve_rank

KW = dict(batch=2, prompt_len=8, gen=6, seed=0)


def cfgs(arch: str):
    return tuple(dataclasses.replace(c.get(arch).smoke(),
                                     compute_dtype="float32")
                 for c in (configs, ref_configs))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


_ONE: dict = {}


def one_process(arch: str, tmp_path_factory):
    """(saved weights, the port's one-process session, the reference's
    tokens), once an arch."""
    if arch not in _ONE:
        cfg, rcfg = cfgs(arch)
        params = jax.jit(RefLM(rcfg).init)(jax.random.PRNGKey(KW["seed"]))
        model = lm_from_jax_params(jax.tree.map(np.asarray, params), cfg,
                                   "cpu")
        path = tmp_path_factory.mktemp(f"serve_{arch}") / "weights.pt"
        torch.save(model.state_dict(), path)
        one = serve_session(cfg, model=model.cast_for_serving(),
                            return_logits=True, **KW)
        ref = np.asarray(ref_serve_session(rcfg, **KW)["generated"])
        _ONE[arch] = (path, one, ref)
    return _ONE[arch]


ARCHS = ("qwen2.5-3b", "phi3.5-moe-42b-a6.6b")
KV_SHARDS = ("heads", "none")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case's ranks, from one spawn of two ranks."""
    tmp = tmp_path_factory.mktemp("tp_serve")
    jobs = [(f"{arch}_{kv}", cfgs(arch)[0], KW,
             dict(data_axes=("data",), model_axes=("model",), kv_shard=kv),
             str(one_process(arch, tmp_path_factory)[0]))
            for arch in ARCHS for kv in KV_SHARDS]
    run_ranks(tp_serve_rank, 2, tmp, shape=(1, 2), axes=("data", "model"),
              args=(jobs, str(tmp)), timeout=120)
    return {job[0]: load_ranks(tmp, 2, job[0]) for job in jobs}


@pytest.mark.parametrize("kv_shard", KV_SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_session_matches_one_process(arch, kv_shard, ranks,
                                                     tmp_path_factory):
    cfg, _ = cfgs(arch)
    _, one, ref = one_process(arch, tmp_path_factory)
    np.testing.assert_array_equal(one["generated"], ref)
    kv = cfg.n_kv_heads // 2 if kv_shard == "heads" else cfg.n_kv_heads
    for r in ranks[f"{arch}_{kv_shard}"]:
        np.testing.assert_array_equal(r["generated"], one["generated"])
        for got, want in zip(r["logits"], one["logits"]):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-5 * float(want.abs().max()))
        # each rank holds its heads: its q heads and the kv heads it caches
        shapes = r["shapes"]
        assert shapes["layers.0.mixer.wq"][1] == cfg.n_heads // 2
        assert shapes["layers.0.mixer.wk"][1] == max(kv, 1)
        assert shapes["embed.tokens"][0] == cfg.vocab_size // 2
        # a decode step: two all-reduces a layer (attention's output
        # projection, the MLP, where its columns are split: an MoE's
        # replicated experts need none), the embedding's sum and the
        # logits' gather; the prefill the same
        mlp = 0 if cfg.moe else 1
        steps = KW["gen"]
        assert r["counts"]["all_reduce_sum@model"]["calls"] == steps * (
            1 + cfg.n_layers * (1 + mlp))
        assert r["counts"]["all_gather@model"]["calls"] == steps
