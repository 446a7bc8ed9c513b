"""repro_torch DNA automaton held against the JAX package's pure oracles.

Everything here is integer arithmetic, so every comparison is exact.  The
reference's Pallas path is not called (it does not run under the
installed jax); the port is held against ``fa_match_ref``,
``chunk_state_map_ref`` and ``compose_maps``.  On the CPU a wrapper takes
its kernel's plain version, which is what these tests reach.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import largest_aligned_divisor as ref_divisor
from repro.kernels.dna_automaton import ops as ref_ops
from repro.kernels.dna_automaton import ref as ref_ref
from repro_torch.convert import dfa_to_device
from repro_torch.kernels import (KernelLaunchError, largest_aligned_divisor,
                                 resolve_launch_params)
from repro_torch.kernels.dna_automaton import kernel, ops, ref

MOTIFS = ["ACGTAC", "AAAA", "ACAC", "G", "GATTACA"]


def text_of(seed, t):
    return np.random.default_rng(seed).integers(0, 4, t).astype(np.uint8)


def dfa(motif):
    table, accept = ops.build_motif_dfa(motif)
    return table, accept, *dfa_to_device(table, accept, "cpu")


# -- shared helpers -----------------------------------------------------------------

def test_divisor_clamps_and_never_asserts():
    assert largest_aligned_divisor(10000, 512) == 500
    assert largest_aligned_divisor(512, 128) == 128
    assert largest_aligned_divisor(512, 1000) == 512
    assert largest_aligned_divisor(384, 128, align=8) == 128
    assert largest_aligned_divisor(15, 6, align=8) == 5
    assert largest_aligned_divisor(7, 3) == 1
    with pytest.raises(ValueError):
        largest_aligned_divisor(0, 4)


def test_divisor_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(300):
        n, cap = int(rng.integers(1, 5000)), int(rng.integers(1, 700))
        align = int(rng.choice([1, 8, 16]))
        assert (largest_aligned_divisor(n, cap, align)
                == ref_divisor(n, cap, align)), (n, cap, align)


def test_launch_param_precedence():
    defaults = {"map_chunk": 2048, "count_chunk": 2048, "block_threads": 256}
    meta = {"t": 4096, "s": 7}
    assert resolve_launch_params("dna_automaton", meta, "uint8",
                                 defaults=defaults, tuned=False) == defaults
    got = resolve_launch_params(
        "dna_automaton", meta, "uint8", defaults=defaults, tuned=False,
        overrides={"map_chunk": 512, "count_chunk": None, "block_threads": 64})
    assert got == {"map_chunk": 512, "count_chunk": 2048, "block_threads": 64}


@pytest.mark.parametrize("motif", MOTIFS + [""])
def test_build_motif_dfa_matches_reference(motif):
    t_ref, a_ref = ref_ops.build_motif_dfa(motif)
    t_port, a_port = ops.build_motif_dfa(motif)
    np.testing.assert_array_equal(t_port, t_ref)
    np.testing.assert_array_equal(a_port, a_ref)
    assert t_port.dtype == np.int32 and a_port.dtype == bool


def test_dfa_to_device_takes_either_package_output():
    for build in (ops.build_motif_dfa, ref_ops.build_motif_dfa):
        table, accept = dfa_to_device(*build("ACGTAC"), "cpu")
        assert table.dtype == accept.dtype == torch.int32
        assert table.shape == (7, 4) and accept.tolist() == [0] * 6 + [1]
        assert table.is_contiguous() and accept.is_contiguous()


# -- the plain versions against the reference's oracles -------------------------------

@pytest.mark.parametrize("motif", MOTIFS)
@pytest.mark.parametrize("t,chunk", [(4096, 256), (3000, 500), (512, 512)])
def test_state_map_plain_matches_chunk_state_map_ref(motif, t, chunk):
    table_np, _, table, _ = dfa(motif)
    text = text_of(1, t)
    maps = kernel.state_map_plain(torch.from_numpy(text), table, chunk=chunk)
    assert maps.shape == (t // chunk, table.shape[0])
    assert maps.dtype == torch.int32
    for i in range(t // chunk):
        piece = text[i * chunk:(i + 1) * chunk]
        want = np.asarray(ref_ref.chunk_state_map_ref(jnp.asarray(piece),
                                                      jnp.asarray(table_np)))
        np.testing.assert_array_equal(maps[i].numpy(), want)
        np.testing.assert_array_equal(ref.chunk_state_map_ref(piece, table_np),
                                      want)


@pytest.mark.parametrize("motif", ["ACGTAC", "AAAA"])
def test_count_hits_plain_matches_fa_match_ref_per_chunk(motif):
    table_np, accept_np, table, accept = dfa(motif)
    t, chunk = 2048, 256
    text = text_of(2, t)
    rng = np.random.default_rng(3)
    starts = rng.integers(0, table_np.shape[0], t // chunk).astype(np.int32)
    counts, ends = kernel.count_hits_plain(
        torch.from_numpy(text), table, accept, torch.from_numpy(starts),
        chunk=chunk)
    assert counts.dtype == ends.dtype == torch.int32
    for i in range(t // chunk):
        piece = jnp.asarray(text[i * chunk:(i + 1) * chunk])
        c, e = ref_ref.fa_match_ref(piece, jnp.asarray(table_np),
                                    jnp.asarray(accept_np), int(starts[i]))
        assert (int(counts[i]), int(ends[i])) == (int(c), int(e))


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33, 100])
def test_compose_maps_matches_reference(n):
    rng = np.random.default_rng(n)
    maps = rng.integers(0, 7, (n, 7)).astype(np.int32)
    want = np.asarray(ref_ops.compose_maps(jnp.asarray(maps)))
    got = ops.compose_maps(torch.from_numpy(maps))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and against the definition: out[i] = m_i[out[i-1]]
    run = maps[0]
    for i in range(1, n):
        run = maps[i][run]
    np.testing.assert_array_equal(got[-1].numpy(), run)


# -- fa_match -----------------------------------------------------------------------

@pytest.mark.parametrize("motif", ["ACGTAC", "AAAA", "ACAC"])
@pytest.mark.parametrize("t,chunk", [(4096, 256), (10000, 512), (4096, 4096)])
def test_fa_match_counts_match_fa_match_ref(t, chunk, motif):
    table, accept = ops.build_motif_dfa(motif)
    text = text_of(4, t)
    want = int(ref_ref.fa_match_ref(jnp.asarray(text), jnp.asarray(table),
                                    jnp.asarray(accept))[0])
    got = ops.fa_match(text, table, accept, chunk=chunk, device="cpu")
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want
    assert int(ops.fa_match_plain(torch.from_numpy(text), table, accept,
                                  chunk=chunk)) == want
    assert ref.fa_match_ref(text, table, accept)[0] == want


def test_overlapping_motif_occurrences():
    table, accept = ops.build_motif_dfa("AAAA")
    text = np.zeros(64, np.uint8)                     # "A" * 64
    assert int(ops.fa_match(text, table, accept, chunk=16, device="cpu")) == 61
    assert int(ref_ref.fa_match_ref(jnp.asarray(text), jnp.asarray(table),
                                    jnp.asarray(accept))[0]) == 61


@pytest.mark.parametrize("mc,cc,start", [(256, 1024, 0), (1024, 256, 0),
                                         (512, 512, 3), (256, 768, 2)])
def test_fa_match_independent_chunks_and_start_state(mc, cc, start):
    """count_chunk falls back to map_chunk when it is not a multiple."""
    table, accept = ops.build_motif_dfa("ACGTAC")
    text = text_of(5, 6144)
    want = int(ref_ref.fa_match_ref(jnp.asarray(text), jnp.asarray(table),
                                    jnp.asarray(accept), start)[0])
    got = ops.fa_match(torch.from_numpy(text), table, accept, map_chunk=mc,
                       count_chunk=cc, start_state=start)
    assert int(got) == want


def test_port_oracle_matches_reference_oracle():
    table, accept = ops.build_motif_dfa("GATTACA")
    text = text_of(6, 3000)
    c, e = ref_ref.fa_match_ref(jnp.asarray(text), jnp.asarray(table),
                                jnp.asarray(accept), 2)
    assert ref.fa_match_ref(torch.from_numpy(text), table, accept, 2) \
        == (int(c), int(e))


# -- where it runs ------------------------------------------------------------------

def test_fa_match_needs_the_card_unless_told_cpu():
    table, accept = ops.build_motif_dfa("ACGTAC")
    text = text_of(7, 1024)
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.fa_match(text, table, accept)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.fa_match(torch.from_numpy(text), table, accept, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.random_dna_text(16, seed=0)
    # an explicit device="cpu", or a tensor that already lies on the CPU
    a = int(ops.fa_match(text, table, accept, device="cpu"))
    b = int(ops.fa_match(torch.from_numpy(text), table, accept))
    assert a == b


def test_wrappers_take_the_plain_version_on_cpu_without_counting_a_launch():
    _, _, table, accept = dfa("ACGTAC")
    text = torch.from_numpy(text_of(8, 1024))
    before = (kernel.state_map.launches, kernel.count_hits.launches)
    maps = kernel.state_map(text, table, chunk=256, block_threads=128)
    starts = torch.zeros(4, dtype=torch.int32)
    counts, ends = kernel.count_hits(text, table, accept, starts, chunk=256)
    assert torch.equal(maps, kernel.state_map_plain(text, table, chunk=256))
    want = kernel.count_hits_plain(text, table, accept, starts, chunk=256)
    assert torch.equal(counts, want[0]) and torch.equal(ends, want[1])
    assert (kernel.state_map.launches, kernel.count_hits.launches) == before


BAD_CALLS = {
    "text_dtype": lambda a: a.update(text=a["text"].to(torch.int32)),
    "text_2d": lambda a: a.update(text=a["text"].view(2, -1)),
    "text_strided": lambda a: a.update(text=a["text"][::2]),
    "text_numpy": lambda a: a.update(text=a["text"].numpy()),
    "chunk_not_dividing": lambda a: a.update(chunk=300),
    "chunk_zero": lambda a: a.update(chunk=0),
    "table_dtype": lambda a: a.update(table=a["table"].long()),
    "table_width": lambda a: a.update(table=a["table"][:, :3].contiguous()),
    "table_strided": lambda a: a.update(table=a["table"].t().contiguous().t()),
    "table_numpy": lambda a: a.update(table=a["table"].numpy()),
    "accept_dtype": lambda a: a.update(accept=a["accept"].bool()),
    "accept_shape": lambda a: a.update(accept=a["accept"][:-1]),
    "starts_dtype": lambda a: a.update(starts=a["starts"].long()),
    "starts_shape": lambda a: a.update(starts=a["starts"][:-1]),
    "block_threads_odd": lambda a: a.update(block_threads=100),
    "block_threads_big": lambda a: a.update(block_threads=2048),
}


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_wrappers_raise_on_what_the_kernels_do_not_take(case):
    _, _, table, accept = dfa("ACGTAC")
    args = dict(text=torch.from_numpy(text_of(9, 1024)), table=table,
                accept=accept, starts=torch.zeros(4, dtype=torch.int32),
                chunk=256, block_threads=256)
    BAD_CALLS[case](args)
    with pytest.raises((TypeError, ValueError)):
        kernel.count_hits(args["text"], args["table"], args["accept"],
                          args["starts"], chunk=args["chunk"],
                          block_threads=args["block_threads"])
    if not case.startswith(("accept", "starts")):
        with pytest.raises((TypeError, ValueError)):
            kernel.state_map(args["text"], args["table"], chunk=args["chunk"],
                             block_threads=args["block_threads"])


def test_too_many_states_and_launch_error_type():
    text = torch.from_numpy(text_of(10, 256))
    table = torch.zeros((kernel.MAX_STATES + 1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="states"):
        kernel.state_map(text, table, chunk=256)
    assert issubclass(KernelLaunchError, RuntimeError)


def test_random_dna_text_is_seeded_uint8_symbols():
    a = ops.random_dna_text(5000, seed=3, device="cpu")
    b = ops.random_dna_text(5000, seed=3, device="cpu")
    c = ops.random_dna_text(5000, seed=4, device="cpu")
    assert a.dtype == torch.uint8 and a.shape == (5000,)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) == 3 and int(a.min()) == 0
    assert np.bincount(a.numpy(), minlength=4).min() > 1000
