"""Sequence-sharded decode (``repro_torch.dist.seq_decode``) over CPU ranks
against the reference's ``decode_attention_ref`` on the whole updated
cache, and B4's logsumexp output (``return_lse``) against the reference's
scores.

The reference's own test (``tests/test_distributed.py::
test_seq_sharded_decode_matches_ref``) runs a (2, 4) mesh at hd 16; the
port's decode kernel takes hd 32 to 192, so the sizes here are the
reference test's with hd 32: B 4, S 64, KV 2, rep 3.  Two layouts: two
ranks with ``kv_shard="seq"`` (stripes of 32, the batch on both) and a
(2, 2) mesh with ``"batch_seq"`` (2 rows and a stripe of 32 a rank).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from helpers_dist import load_ranks, run_ranks, seq_decode_rank

B, S, KV, REP, HD = 4, 64, 2, 3, 32
# the first position, inside the first stripe (the second one empty: no
# attention there), the stripes' edges, the reference test's 37, the last
POSITIONS = (0, 5, 31, 32, 37, 63)
LAYOUTS = {"seq": (2, (2,), ("data",)),
           "batch_seq": (4, (2, 2), ("data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread in this process while its tests run, as every rank has:
    under pytest-xdist the workers share the cores, and many small
    parallel regions on oversubscribed cores run tens of times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def inputs():
    rng = np.random.default_rng(0)

    def draw(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"q": draw(B, KV * REP, HD), "kn": draw(B, KV, HD),
            "vn": draw(B, KV, HD), "ck": draw(B, S, KV, HD),
            "cv": draw(B, S, KV, HD)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    x = inputs()
    out = {}
    for layout, (world, shape, axes) in LAYOUTS.items():
        d = tmp_path_factory.mktemp(layout)
        torch.save({k: torch.from_numpy(v) for k, v in x.items()},
                   d / "inputs.pt")
        run_ranks(seq_decode_rank, world, d, shape=shape, axes=axes,
                  args=(layout, str(d / "inputs.pt"), str(d), POSITIONS))
        out[layout] = load_ranks(d, world)
    return x, out


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_seq_decode_matches_reference(runs, layout, pos):
    x, out = runs
    ck = jnp.asarray(x["ck"]).at[:, pos].set(x["kn"])
    cv = jnp.asarray(x["cv"]).at[:, pos].set(x["vn"])
    want = np.asarray(decode_attention_ref(jnp.asarray(x["q"]), ck, cv,
                                           length=pos + 1))
    ck, cv = np.asarray(ck), np.asarray(cv)
    covered = np.zeros((B, S), bool)
    for rank in out[layout]:
        b0, s0, run = rank["b0"], rank["s0"], rank["runs"][pos]
        bl, sl = run["ck"].shape[:2]
        np.testing.assert_allclose(run["out"].numpy(), want[b0:b0 + bl],
                                   rtol=0, atol=1e-5)
        # every stripe equal to the updated cache's
        np.testing.assert_array_equal(run["ck"].numpy(),
                                      ck[b0:b0 + bl, s0:s0 + sl])
        np.testing.assert_array_equal(run["cv"].numpy(),
                                      cv[b0:b0 + bl, s0:s0 + sl])
        covered[b0:b0 + bl, s0:s0 + sl] = True
    assert covered.all()


def ref_scores(q, k, length):
    """The reference oracle's masked scores (B, KV, rep, S)."""
    b, h, hd = q.shape
    qf = jnp.asarray(q).reshape(b, KV, h // KV, hd) * hd ** -0.5
    s = jnp.einsum("bgrh,bsgh->bgrs", qf, jnp.asarray(k))
    valid = jnp.arange(k.shape[1]) < length
    return jnp.where(valid[None, None, None, :], s, -1e30)


@pytest.mark.parametrize("length, splits", [(1, 1), (5, 4), (37, 4),
                                            (64, 16), (33, 2)])
def test_b4_lse_matches_reference_logsumexp(length, splits):
    x = inputs()
    q = torch.from_numpy(x["q"]).reshape(B, KV, REP, HD)
    k, v = torch.from_numpy(x["ck"]), torch.from_numpy(x["cv"])
    out, lse = da_kernel.decode_attention(q, k, v, length, splits=splits,
                                          return_lse=True)
    want = np.asarray(jax.nn.logsumexp(ref_scores(x["q"], x["ck"], length),
                                       axis=-1))
    assert lse.shape == (B, KV, REP) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    # the output keeps its bits with the lse asked for
    plain = da_kernel.decode_attention(q, k, v, length, splits=splits)
    assert torch.equal(out, plain)
    # and the wrapper's (B, H, hd) form carries the same pair
    o2, l2 = da_ops.decode_attention(torch.from_numpy(x["q"]), k, v,
                                     length=length, splits=splits,
                                     return_lse=True)
    assert torch.equal(o2, out.reshape(B, KV * REP, HD))
    assert torch.equal(l2, lse)


def test_combine_splits_lse_is_the_whole_logsumexp():
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.standard_normal((2, 4, 2, 3, 32))
                           .astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((2, 4, 2, 3)).astype(np.float32))
    m[:, 3] = da_kernel.NEG_INF                  # a segment past the fill
    l = torch.from_numpy(rng.random((2, 4, 2, 3)).astype(np.float32) + 0.5)
    l[:, 3] = 0.0
    out, lse = da_kernel.combine_splits(acc, m, l, return_lse=True)
    want = torch.logsumexp(m[:, :3] + torch.log(l[:, :3]), dim=1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-6)
    assert torch.equal(out, da_kernel.combine_splits(acc, m, l))
