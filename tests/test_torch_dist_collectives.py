"""The differentiable collectives of ``repro_torch.dist.collectives`` and
the block arithmetic of ``dist.sharding`` on a (2, 2) mesh of CPU ranks.

Each op runs along ``data``, ``model`` and both, through each route
(``ROUTE``): the all-reduce construction (gloo's, on the card as here)
and the native ops (NCCL's branch, which gloo runs on the CPU); its
result is
held against the one-process result over the same group, and its
gradient against the one-process transpose under the port's convention
(the loss is the sum over ranks: rank r's loss is ``<w_r, out_r>``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from helpers_dist import (COLLECTIVE_AXES, COLLECTIVE_ROUTES, LEAF_SPECS,
                          collectives_rank, load_ranks, run_ranks)

SHAPE = (2, 2)                       # (data, model): rank = 2 * d + m
WORLD = 4
OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_max")


def group(rank: int, axes) -> list[int]:
    """The ranks that differ from ``rank`` only along ``axes``, in the
    order of their flattened coordinate along ``axes``."""
    d, m = divmod(rank, 2)
    ds = [0, 1] if "data" in axes else [d]
    ms = [0, 1] if "model" in axes else [m]
    return [2 * a + b for a in ds for b in ms]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    inputs = {"x": draw(WORLD, 3, 4), "w_all_reduce": draw(WORLD, 3, 4),
              "w_all_gather": draw(WORLD, 3, 16),
              "w_reduce_scatter": draw(WORLD, 3, 4), "leaf": draw(8, 12)}
    # each rank's cotangent is its saved row cut to its output's width
    torch.save(inputs, tmp / "inputs.pt")
    run_ranks(collectives_rank, WORLD, tmp, shape=SHAPE,
              axes=("data", "model"), args=(str(tmp / "inputs.pt"),
                                            str(tmp)), timeout=90)
    return inputs, load_ranks(tmp, WORLD)


def expected(inputs, rank: int, axes, op: str):
    """(result, gradient of the summed losses) in one process."""
    x = inputs["x"]
    g = group(rank, axes)
    n, i = len(g), g.index(rank)
    if op == "all_reduce":
        return sum(x[r] for r in g), sum(inputs["w_all_reduce"][r]
                                         for r in g)
    if op == "all_max":
        return torch.stack([x[r] for r in g]).amax(0), None
    if op == "all_gather":
        w = inputs["w_all_gather"]
        return (torch.cat([x[r] for r in g], dim=1),
                sum(w[r][:, 4 * i:4 * (i + 1)] for r in g))
    per = 4 // n
    w = inputs["w_reduce_scatter"]
    grad = torch.cat([w[r][:, :per] for r in g], dim=1)
    return sum(x[r] for r in g)[:, per * i:per * (i + 1)], grad


@pytest.mark.parametrize("route", COLLECTIVE_ROUTES)
@pytest.mark.parametrize("axes", COLLECTIVE_AXES)
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_one_process(ranks, route, axes, op):
    inputs, out = ranks
    for rank in range(WORLD):
        got = out[rank][(route, axes, op)]
        want, _ = expected(inputs, rank, axes, op)
        torch.testing.assert_close(got["y"], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("route", COLLECTIVE_ROUTES)
@pytest.mark.parametrize("axes", COLLECTIVE_AXES)
@pytest.mark.parametrize("op", OPS[:3])
def test_collective_gradient_is_its_transpose(ranks, route, axes, op):
    inputs, out = ranks
    for rank in range(WORLD):
        got = out[rank][(route, axes, op)]["grad"]
        _, want = expected(inputs, rank, axes, op)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("route", COLLECTIVE_ROUTES)
def test_counters_count_calls_and_bytes(ranks, route):
    """One call each, keyed by op and axes; the bytes handed to the
    backend: the buffer an all-reduce sums (an all-gather's whole result
    through the all-reduce, the gathered blocks natively)."""
    _, out = ranks
    for axes in COLLECTIVE_AXES:
        n = len(group(0, axes))
        key = "+".join(axes)
        counts = {op: out[0][(route, axes, op)]["counts"] for op in OPS}
        assert counts["all_reduce"] == {f"all_reduce_sum@{key}": {
            "calls": 1, "bytes": 48, "seconds": counts["all_reduce"][
                f"all_reduce_sum@{key}"]["seconds"]}}
        assert list(counts["all_max"]) == [f"all_reduce_max@{key}"]
        gather = counts["all_gather"][f"all_gather@{key}"]
        assert (gather["calls"], gather["bytes"]) == (1, 48 * n)
        scatter = counts["reduce_scatter"][f"reduce_scatter@{key}"]
        assert (scatter["calls"], scatter["bytes"]) == (1, 48)


@pytest.mark.parametrize("spec", LEAF_SPECS)
def test_shard_and_unshard_leaf(ranks, spec):
    """Each rank's block is the leaf sliced by its coordinates (an entry
    of two axes: row-major in the order given); the blocks gather back to
    the whole leaf on every rank."""
    inputs, out = ranks
    leaf = inputs["leaf"]
    for rank in range(WORLD):
        d, m = divmod(rank, 2)
        coord = {"data": d, "model": m}
        want = leaf
        for dim, entry in enumerate(spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            idx = 0
            for a in axes:
                idx = idx * 2 + coord[a]
            per = leaf.shape[dim] // 2 ** len(axes)
            want = want.narrow(dim, idx * per, per)
        got = out[rank][("leaf", spec)]
        assert torch.equal(got["block"], want)
        assert torch.equal(got["whole"], leaf)
