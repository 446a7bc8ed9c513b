"""Sequence-sharded serving (``serve_session(scfg=, mesh=)`` with
``kv_shard="seq"``) over two CPU ranks against the one-process session:
the same tokens on every rank, float32 logits within 1e-5."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.serve import serve_session
from repro_torch.models import build_model
from helpers_dist import load_ranks, run_ranks, serve_rank

CFG = dataclasses.replace(configs.get("qwen2.5-3b").smoke(),
                          compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread in this process while its tests run, as every rank has:
    under pytest-xdist the workers share the cores, and many small
    parallel regions on oversubscribed cores run tens of times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("prompt_len, gen", [
    (16, 8),        # stripes of 12: the prompt spans both
    (4, 8),         # stripes of 6: the second is empty for two steps
])
def test_seq_sharded_session_matches_one_process(tmp_path, prompt_len, gen):
    kw = dict(batch=2, prompt_len=prompt_len, gen=gen, seed=3)
    run_ranks(serve_rank, 2, tmp_path, shape=(2,), axes=("data",),
              args=(CFG, kw, str(tmp_path)))
    ranks = load_ranks(tmp_path, 2)
    model = build_model(CFG, seed=3, device="cpu").cast_for_serving()
    want = serve_session(CFG, model=model, return_logits=True, **kw)
    for rank in ranks:
        # every layer's decode went through the sequence-sharded path
        assert rank["seq_decode_calls"] == CFG.n_layers * (gen - 1)
        np.testing.assert_array_equal(rank["generated"], want["generated"])
        assert len(rank["logits"]) == gen
        for got, ref in zip(rank["logits"], want["logits"]):
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=1e-5 * float(ref.abs().max()))


def test_seq_sharded_caches_hold_the_stripes(tmp_path):
    """Under the rules each attention cache is the rank's stripe, and
    prefill fills it with the prompt's keys from its offset on."""
    from helpers_dist import stripe_rank

    run_ranks(stripe_rank, 2, tmp_path, shape=(2,), axes=("data",),
              args=(CFG, str(tmp_path)))
    ranks = load_ranks(tmp_path, 2)
    model = build_model(CFG, seed=0, device="cpu").cast_for_serving()
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, 10)))
    _, whole = model.prefill(tokens, max_len=16)
    for r, rank in enumerate(ranks):
        for layer, cache in zip(whole, rank["caches"]):
            assert cache["k"].shape == (2, 8, CFG.n_kv_heads, CFG.head_dim)
            torch.testing.assert_close(cache["k"],
                                       layer["k"][:, 8 * r:8 * r + 8])
            torch.testing.assert_close(cache["v"],
                                       layer["v"][:, 8 * r:8 * r + 8])
        assert rank["s0"] == [8 * r] * CFG.n_layers
