"""Gradient compression (``repro_torch.dist.compression``) against the
reference's ``repro.dist.compression`` on the same numpy inputs, the
reference's own cases (``tests/test_substrates.py``), and the compressed
all-reduce over four CPU ranks (gloo) against the mean of the reference's
per-rank compression."""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist import compression as ref
from repro_torch.dist import compression as port
from helpers_dist import allreduce_rank, run_ranks


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread in this process while its tests run, as every rank has:
    under pytest-xdist the workers share the cores, and many small
    parallel regions on oversubscribed cores run tens of times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def draws(seed: int, n: int = 4096, kind: str = "normal") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.standard_normal(n).astype(np.float32)
    if kind == "halves":
        # exact halves of the code grid: x / scale lands on k + 0.5
        x = (rng.integers(-120, 120, n) + 0.5).astype(np.float32)
        x[0] = 127.0
        return x
    # many equal magnitudes, for top-k ties
    return rng.choice(np.float32([-2, -1, 1, 2, 0.5]), n).astype(np.float32)


@pytest.mark.parametrize("seed, kind", [(0, "normal"), (1, "normal"),
                                        (2, "halves"), (3, "ties")])
def test_quantize_int8_matches_reference(seed, kind):
    x = draws(seed, kind=kind)
    q, s = port.quantize_int8(torch.from_numpy(x))
    rq, rs = ref.quantize_int8(jnp.asarray(x))
    assert float(s) == float(rs)
    diff = np.abs(q.numpy().astype(int) - np.asarray(rq).astype(int))
    # equal codes, or one apart only where x / scale is an exact half
    frac = np.abs(x / float(s)) % 1.0
    assert diff.max() <= 1
    assert np.all(np.isclose(frac[diff == 1], 0.5, atol=1e-4))
    back = port.dequantize_int8(q, s, x.shape).numpy()
    assert np.abs(back - x).max() <= np.abs(x).max() / 127.0


@pytest.mark.parametrize("frac", [0.25, 0.01, 2 / 6])
@pytest.mark.parametrize("seed, kind", [(0, "normal"), (3, "ties")])
def test_topk_matches_reference(seed, kind, frac):
    x = draws(seed, kind=kind)
    v, i = port.topk_compress(torch.from_numpy(x), frac)
    rv, ri = ref.topk_compress(jnp.asarray(x), frac)
    # lax.top_k keeps the lower index of equal magnitudes, largest first
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(
        port.topk_decompress(v, i, x.shape).numpy(),
        np.asarray(ref.topk_decompress(rv, ri, x.shape)))


def test_topk_keeps_largest():
    x = torch.tensor([0.1, -5.0, 0.2, 3.0, -0.05, 0.0])
    v, i = port.topk_compress(x, 2 / 6)
    np.testing.assert_allclose(port.topk_decompress(v, i, x.shape).numpy(),
                               [0, -5.0, 0, 3.0, 0, 0])


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_compress_with_feedback_matches_reference(scheme):
    rng = np.random.default_rng(5)
    shapes = {"w": (16, 24), "b": (24,), "e": (3, 5, 7)}
    cfg = port.CompressionConfig(scheme=scheme, topk_frac=0.25)
    rcfg = ref.CompressionConfig(scheme=scheme, topk_frac=0.25)
    err = port.init_error_state({k: torch.zeros(s) for k, s in
                                 shapes.items()})
    rerr = ref.init_error_state({k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(4):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        got, err = port.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, err, cfg)
        want, rerr = ref.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, rerr, rcfg)
        for k in shapes:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(err[k].numpy(), np.asarray(rerr[k]),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("scheme, frac", [("none", 0.25), ("int8", 0.25),
                                          ("topk", 0.01), ("topk", 0.25)])
def test_wire_bytes_matches_reference(scheme, frac):
    shapes = {"w": (1024,), "v": (256,), "m": (33, 7)}
    got = port.wire_bytes({k: torch.zeros(s) for k, s in shapes.items()},
                          port.CompressionConfig(scheme, topk_frac=frac))
    want = ref.wire_bytes({k: jnp.zeros(s) for k, s in shapes.items()},
                          ref.CompressionConfig(scheme, topk_frac=frac))
    assert got == want
    bf16 = port.wire_bytes({"w": torch.zeros(10, dtype=torch.bfloat16)},
                           port.CompressionConfig("none"))
    assert bf16 == 20


def test_error_feedback_preserves_convergence():
    """SGD on least squares: int8-EF matches uncompressed closely; top-k-EF
    still converges (slower) — the reference's bounds."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))

    def run(scheme, steps=150, lr=0.02):
        cfg = port.CompressionConfig(scheme=scheme, topk_frac=0.25)
        w = {"w": torch.zeros(16, requires_grad=True)}
        err = port.init_error_state(w)
        for _ in range(steps):
            loss = torch.mean((a @ w["w"] - b) ** 2)
            (g,) = torch.autograd.grad(loss, [w["w"]])
            g, err = port.compress_with_feedback({"w": g}, err, cfg)
            with torch.no_grad():
                w["w"] -= lr * g["w"]
        return float(torch.mean((a @ w["w"].detach() - b) ** 2))

    base = run("none")
    assert run("int8") < base * 1.05 + 1e-4
    assert run("topk") < base * 2.0 + 0.05


def test_compressed_allreduce_over_four_ranks(tmp_path):
    x = np.random.default_rng(0).standard_normal((4, 257)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    out_path = tmp_path / "out.json"
    run_ranks(allreduce_rank, 4, tmp_path, shape=(4,), axes=("data",),
              args=(str(tmp_path / "x.npy"), str(out_path)))
    got = json.loads(out_path.read_text())
    mean = x.mean(axis=0, keepdims=True)
    for scheme in ("int8", "topk"):
        cfg = ref.CompressionConfig(scheme=scheme, topk_frac=0.25)
        want = np.mean([np.asarray(ref._compress_leaf(jnp.asarray(x[r:r + 1]),
                                                      cfg)) for r in range(4)],
                       axis=0)
        np.testing.assert_allclose(np.asarray(got[scheme]), want, rtol=0,
                                   atol=1e-6)
    # the reference's gate for int8: within max|x| / 100 of the true mean
    assert np.abs(np.asarray(got["int8"]) - mean).max() < np.abs(x).max() / 100
    np.testing.assert_allclose(np.asarray(got["none"]), mean, atol=1e-6)


def test_stack_groups_follow_the_reference_stacks():
    names = ["embed.tokens", "layers.0.mixer.wq", "layers.1.mixer.wq",
             "layers.2.mixer.wq", "layers.3.mixer.wq", "layers.1.norm1.scale",
             "encoder.1.attn.wq", "encoder.0.attn.wq", "final_norm.scale"]
    groups = port.stack_groups(names, 2)
    assert groups == {
        "embed.tokens": ["embed.tokens"],
        "layers.slot0.mixer.wq": ["layers.0.mixer.wq", "layers.2.mixer.wq"],
        "layers.slot1.mixer.wq": ["layers.1.mixer.wq", "layers.3.mixer.wq"],
        "layers.slot1.norm1.scale": ["layers.1.norm1.scale"],
        "encoder.attn.wq": ["encoder.0.attn.wq", "encoder.1.attn.wq"],
        "final_norm.scale": ["final_norm.scale"]}


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_compress_stacked_matches_reference_on_stacked_leaves(scheme):
    rng = np.random.default_rng(9)
    grads = {f"layers.{i}.w": rng.standard_normal((6, 5)).astype(np.float32)
             * (i + 1) for i in range(4)}
    grads["head"] = rng.standard_normal(7).astype(np.float32)
    cfg = port.CompressionConfig(scheme=scheme)
    groups = port.stack_groups(grads, 2)
    got, err = port.compress_stacked(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.zeros(v.shape) for k, v in grads.items()}, cfg, groups)
    stacked = {k: jnp.stack([grads[n] for n in ns]) for k, ns in
               groups.items()}
    want, rerr = ref.compress_with_feedback(
        stacked, jax_zeros(stacked), ref.CompressionConfig(scheme=scheme))
    for k, ns in groups.items():
        for i, n in enumerate(ns):
            np.testing.assert_allclose(got[n].numpy(), np.asarray(want[k][i]),
                                       rtol=0, atol=1e-6)
            np.testing.assert_allclose(err[n].numpy(),
                                       np.asarray(rerr[k][i]), rtol=0,
                                       atol=1e-6)


def jax_zeros(tree):
    return {k: jnp.zeros(v.shape) for k, v in tree.items()}
