"""The DNA kernels' formulation on the CPU: k-gram tables, slices composed
in slice order, and the launch space drawn for them.

``gram_tables``, ``state_map_gram_plain`` and ``count_hits_gram_plain`` are
what the CUDA kernels compute, in plain PyTorch; they are held exactly
against the JAX package's oracles (``chunk_state_map_ref``,
``fa_match_ref``) on numpy-seeded text, with tails that are not a whole
k-gram and chunks cut into uneven slices.  Motifs: ``ACGTAC`` (S = 7,
served), ``AAAA`` (overlapping matches), ``ACGTACGT`` (S = 9, served) and
a 20-letter motif (S = 21, the gather route).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.dna_automaton import ref as ref_ref
from repro_torch.convert import dfa_to_device
from repro_torch.kernels import SMEM_LIMIT_BYTES
from repro_torch.kernels.dna_automaton import kernel, ops
from repro_torch.tune import kernels as ktune

MOTIFS = ["ACGTAC", "AAAA", "ACGTACGT", "ACGTTGCAAGCTTCGAACGT"]


def text_of(seed, t):
    return np.random.default_rng(seed).integers(0, 4, t).astype(np.uint8)


def dfa(motif):
    table, accept = ops.build_motif_dfa(motif)
    return table, accept, *dfa_to_device(table, accept, "cpu")


def kstring(g, k):
    """The k symbols of k-gram index g (b0 | b1 << 2 | ...), in order."""
    return np.asarray([(g >> (2 * i)) & 3 for i in range(k)], np.uint8)


# the reference's oracles over every k-string (and every start state) at
# once: vmapped and compiled, one call a table
_maps_ref = jax.jit(jax.vmap(ref_ref.chunk_state_map_ref, (0, None)))
_hits_ref = jax.jit(jax.vmap(jax.vmap(ref_ref.fa_match_ref,
                                      (None, None, None, 0)),
                             (0, None, None, None)))


@pytest.mark.parametrize("motif", MOTIFS)
@pytest.mark.parametrize("k", kernel.GRAMS)
def test_gram_tables_match_the_reference_over_every_k_string(motif, k):
    table_np, accept_np, table, accept = dfa(motif)
    nxt, hits = kernel.gram_tables(table, accept, k)
    s = table_np.shape[0]
    assert nxt.shape == hits.shape == (s, 4 ** k)
    pieces = jnp.asarray(np.stack([kstring(g, k) for g in range(4 ** k)]))
    want = np.asarray(_maps_ref(pieces, jnp.asarray(table_np)))   # (4^k, S)
    np.testing.assert_array_equal(nxt.T.numpy(), want)
    c, e = _hits_ref(pieces, jnp.asarray(table_np), jnp.asarray(accept_np),
                     jnp.arange(s, dtype=jnp.int32))              # (4^k, S)
    np.testing.assert_array_equal(hits.T.numpy(), np.asarray(c))
    np.testing.assert_array_equal(nxt.T.numpy(), np.asarray(e))
    # spot check against one plain call of the oracle
    g, st = 4 ** k - 1, s - 1
    one = ref_ref.fa_match_ref(jnp.asarray(kstring(g, k)),
                               jnp.asarray(table_np), jnp.asarray(accept_np),
                               st)
    assert (int(hits[st, g]), int(nxt[st, g])) == (int(one[0]), int(one[1]))
    # the packed entries hold at most k visits
    assert int(hits.max()) <= k


def test_gram_tables_clamp_out_of_range_entries():
    table = torch.tensor([[0, 5, -1, 1], [1, 0, 2, 9], [2, 2, 0, 1]],
                         dtype=torch.int32)
    nxt, _ = kernel.gram_tables(table, None, 1)
    np.testing.assert_array_equal(nxt.numpy(),
                                  [[0, 2, 0, 1], [1, 0, 2, 2], [2, 2, 0, 1]])


@pytest.mark.parametrize("motif", MOTIFS)
@pytest.mark.parametrize("gram", kernel.GRAMS)
@pytest.mark.parametrize("chunk,slices", [
    (1001, 4),      # slices 256, 256, 256, 233: uneven, a 1-symbol tail
    (640, 3),       # 224, 224, 192
    (96, 8),        # 16 x 6, two empty slices
    (35, 1),        # one slice, a tail of 3
])
def test_state_map_gram_plain_matches_chunk_state_map_ref(motif, gram, chunk,
                                                          slices):
    table_np, _, table, _ = dfa(motif)
    n = 3
    text = text_of(11 + chunk, n * chunk)
    maps = kernel.state_map_gram_plain(torch.from_numpy(text), table,
                                       chunk=chunk, gram=gram, slices=slices)
    assert maps.dtype == torch.int32 and maps.shape == (n, table_np.shape[0])
    for i in range(n):
        want = np.asarray(ref_ref.chunk_state_map_ref(
            jnp.asarray(text[i * chunk:(i + 1) * chunk]),
            jnp.asarray(table_np)))
        np.testing.assert_array_equal(maps[i].numpy(), want)


def test_slices_are_whole_units_and_cover_the_chunk():
    for chunk, slices in ((1001, 4), (32768, 256), (96, 8), (16, 128)):
        lq = kernel.slice_length(chunk, slices)
        assert lq % 16 == 0 and lq * slices >= chunk
        assert lq * (slices - 1) < chunk or lq == 16
        bounds = [(min(chunk, t * lq), min(chunk, (t + 1) * lq))
                  for t in range(slices)]
        assert bounds[0][0] == 0 and bounds[-1][1] == chunk
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("motif", MOTIFS)
@pytest.mark.parametrize("gram", kernel.GRAMS)
@pytest.mark.parametrize("chunk", [1001, 256, 35])
def test_count_hits_gram_plain_matches_fa_match_ref(motif, gram, chunk):
    table_np, accept_np, table, accept = dfa(motif)
    n = 4
    text = text_of(23 + chunk, n * chunk)
    starts = np.random.default_rng(chunk).integers(
        0, table_np.shape[0], n).astype(np.int32)
    counts, ends = kernel.count_hits_gram_plain(
        torch.from_numpy(text), table, accept, torch.from_numpy(starts),
        chunk=chunk, gram=gram)
    assert counts.dtype == ends.dtype == torch.int32
    for i in range(n):
        c, e = ref_ref.fa_match_ref(
            jnp.asarray(text[i * chunk:(i + 1) * chunk]),
            jnp.asarray(table_np), jnp.asarray(accept_np), int(starts[i]))
        assert (int(counts[i]), int(ends[i])) == (int(c), int(e))


@pytest.mark.parametrize("motif", MOTIFS)
def test_the_formulation_end_to_end_matches_fa_match_ref(motif):
    """maps in slices -> compose -> counts from the true start states,
    the way fa_match runs the kernels, against the sequential oracle."""
    table_np, accept_np, table, accept = dfa(motif)
    mc, cc, t = 512, 1024, 6144
    text = torch.from_numpy(text_of(5, t))
    maps = kernel.state_map_gram_plain(text, table, chunk=mc, gram=4,
                                       slices=8)
    prefix = ops.compose_maps(maps)
    rep = cc // mc
    starts = torch.cat([torch.zeros(1, dtype=torch.int32),
                        prefix[rep - 1::rep, 0][:t // cc - 1]])
    counts, _ = kernel.count_hits_gram_plain(text, table, accept, starts,
                                             chunk=cc, gram=2)
    want = ref_ref.fa_match_ref(jnp.asarray(text.numpy()),
                                jnp.asarray(table_np),
                                jnp.asarray(accept_np))[0]
    assert int(counts.sum()) == int(want)


# -- routes, tables and shared memory ------------------------------------------------

def test_routes_and_effective_grams():
    assert [kernel.route_of(s) for s in (1, 7, 9, 16, 17, 21, 3072)] == [
        "vector"] * 4 + ["gather"] * 3
    # the vector route takes every gram; the gather and count tables the
    # largest k that fits 64 KB (and uint16 entries)
    assert kernel.effective_gram("vector", 16, 4) == 4
    assert kernel.effective_gram("gather", 21, 4) == 4
    assert kernel.effective_gram("gather", 200, 4) == 2
    assert kernel.effective_gram("gather", 3072, 4) == 1
    assert kernel.effective_gram("count", 7, 4) == 4
    assert kernel.effective_gram("count", 64, 4) == 4     # 64 KB exactly
    assert kernel.effective_gram("count", 65, 4) == 2
    assert kernel.effective_gram("count", 3072, 2) == 1
    assert kernel.effective_gram("count", 3072, 1) == 1


@pytest.mark.parametrize("kind, s, threads, gram, want", [
    # 16-byte columns (4^k + 4), a 16-byte map a thread, a warp's ring of
    # 3 slots x 32 rows x 144 bytes
    ("vector", 7, 256, 4, 16 * (256 + 4 + 256) + 8 * 3 * 32 * 144),
    ("vector", 16, 128, 1, 16 * (4 + 4 + 128) + 4 * 3 * 32 * 144),
    # uint16 one-symbol and k-gram tables (rounded to 8 entries), a warp's
    # ring of 3 slots x 512 bytes
    ("gather", 21, 256, 4, 2 * (88 + 21 * 256) + 8 * 3 * 512),
    ("gather", 3072, 256, 4, 2 * (3072 * 4 * 2) + 8 * 3 * 512),
    # int32 packed tables (one-symbol, and k-gram when k > 1)
    ("count", 7, 256, 4, 4 * (28 + 7 * 256) + 8 * 3 * 32 * 144),
    ("count", 9, 64, 1, 4 * 36 + 2 * 3 * 32 * 144),
])
def test_smem_accounting_matches_the_source(kind, s, threads, gram, want):
    assert kernel.smem_bytes(kind, s, threads, gram) == want


def test_every_valid_point_fits_and_the_biggest_blocks_do_not():
    for s in (7, 9, 21, 3072):
        for kind in (kernel.route_of(s), "count"):
            for threads in (64, 128, 256):
                for gram in kernel.GRAMS:
                    assert kernel.smem_bytes(kind, s, threads, gram) \
                        <= SMEM_LIMIT_BYTES
    # 16 warps' rings of 32-row text slots and 256 4-gram columns do not fit
    assert kernel.smem_bytes("vector", 7, 512, 4) > SMEM_LIMIT_BYTES


# -- the launch space ------------------------------------------------------------------

@pytest.mark.parametrize("s", [7, 9, 21])
def test_space_holds_64_valid_points_and_a_valid_default(s):
    spec = ktune.get_kernel("dna_automaton")
    meta = dict(spec.default_shape, s=s)
    space = spec.space(meta)
    assert space.names == ("map_chunk", "count_chunk", "block_threads",
                           "gram")
    assert space.size() <= 500
    valid = [c for c in space.enumerate() if spec.validate(c, meta) is None]
    assert len(valid) >= 64
    assert spec.validate(dict(ops.DEFAULTS), meta) is None
    assert spec.default_config(space, meta) == ops.DEFAULTS
    # every valid point passes the wrappers' launch checks at this shape
    for c in valid:
        assert kernel._check_launch(kernel.route_of(s), s, c["block_threads"],
                                    c["gram"])[0] == c["block_threads"]
        kernel._check_launch("count", s, c["block_threads"], c["gram"])


@pytest.mark.parametrize("motif", ["ACGTAC", "ACGTACGT",
                                   "ACGTTGCAAGCTTCGAACGT"])
def test_every_valid_point_is_taken_by_the_wrappers_on_cpu(motif):
    """At the smoke text, each valid point of the space runs through both
    wrappers (their checks, then the plain versions) and ``fa_match``
    counts what the sequential oracle counts."""
    table_np, accept_np, table, accept = dfa(motif)
    spec = ktune.get_kernel("dna_automaton")
    meta = dict(spec.smoke_shape, s=table_np.shape[0])
    space = spec.space(meta)
    valid = [c for c in space.enumerate() if spec.validate(c, meta) is None]
    assert len(valid) >= 27
    text = torch.from_numpy(text_of(31, meta["t"]))
    want = ref_ref.fa_match_ref(jnp.asarray(text.numpy()),
                                jnp.asarray(table_np),
                                jnp.asarray(accept_np))[0]
    maps = {}
    for c in valid:
        key = c["map_chunk"]
        got = kernel.state_map(text, table, chunk=key,
                               block_threads=c["block_threads"],
                               gram=c["gram"])
        if key in maps:
            assert torch.equal(got, maps[key])
        maps[key] = got
        starts = torch.zeros(meta["t"] // c["count_chunk"], dtype=torch.int32)
        kernel.count_hits(text, table, accept, starts, chunk=c["count_chunk"],
                          block_threads=c["block_threads"], gram=c["gram"])
    for c in valid[::9]:
        assert int(ops.fa_match(text, table_np, accept_np, **c)) == int(want)


@pytest.mark.parametrize("bad, match", [
    (dict(gram=3), "gram"),
    (dict(block_threads=512), r"\[32, 256\]"),
    (dict(block_threads=96), None),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(bad, match):
    _, _, table, accept = dfa("ACGTAC")
    text = torch.from_numpy(text_of(3, 1024))
    kw = {"chunk": 256, "block_threads": 256, "gram": 4, **bad}
    if match is None:               # 3 warps: a valid block
        kernel.state_map(text, table, **kw)
        return
    with pytest.raises(ValueError, match=match):
        kernel.state_map(text, table, **kw)
    with pytest.raises(ValueError, match=match):
        kernel.count_hits(text, table, accept, torch.zeros(4, dtype=torch.int32),
                          **kw)


def test_an_unaligned_slice_and_odd_chunks_are_taken():
    """text[1:] (an unaligned pointer on the card) and a chunk that is no
    multiple of 16 go through the wrappers: the kernels walk the units a
    range cuts one symbol at a time, so nothing is refused."""
    table_np, accept_np, table, accept = dfa("ACGTACGT")
    full = torch.from_numpy(text_of(9, 1 + 5 * 333))
    text = full[1:]
    assert text.storage_offset() == 1 and text.is_contiguous()
    maps = kernel.state_map(text, table, chunk=333, gram=4)
    assert torch.equal(maps, kernel.state_map_gram_plain(text, table,
                                                         chunk=333, slices=7))
    want = ref_ref.fa_match_ref(jnp.asarray(text.numpy()),
                                jnp.asarray(table_np),
                                jnp.asarray(accept_np))[0]
    assert int(ops.fa_match(text, table_np, accept_np, map_chunk=333,
                            count_chunk=999)) == int(want)
