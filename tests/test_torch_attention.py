"""Kernels B3 (flash-attention forward) and B4 (split-KV decode attention)
of the port, on the CPU (their plain PyTorch versions), held against the
JAX package's oracles on the same numpy-seeded inputs; plus their
launch-parameter spaces and a CPU tune at the smoke shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.ref import attention_ref
from repro.tune.kernels import kernel_workload as ref_kernel_workload
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.runtime.store import TuningStore
from repro_torch.tune import kernels as ktune
from repro_torch.tune.kernels import specs
from helpers_torch import fake_delta, on_fake_card

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# tolerances of tests/test_kernels.py: f32 2e-5; bf16 2e-2 (one bf16 ulp of
# an O(1) output is 2^-7 ~ 8e-3, and the two packages round the output
# from differently ordered float32 sums)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def both(arr: np.ndarray, dtype: str = "float32"):
    """One numpy array as a JAX array and a CPU tensor of the same dtype
    (both round float64 -> bf16 to nearest even)."""
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(arr, jdt),
            torch.from_numpy(np.asarray(arr, np.float32)).to(tdt))


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# -- B3: flash attention ----------------------------------------------------------

@pytest.mark.parametrize("b,t,h,hd,causal,dtype", [
    (2, 256, 4, 64, True, "float32"),
    (1, 128, 2, 128, False, "float32"),
    (2, 384, 3, 64, True, "float32"),
    (1, 256, 2, 64, True, "bfloat16"),
])
def test_flash_attention_matches_reference(b, t, h, hd, causal, dtype):
    rng = np.random.default_rng(42)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal((b, t, h, hd)),
                                         dtype) for _ in range(3))
    got = fa_ops.flash_attention(qt, kt, vt, causal=causal)
    want = attention_ref(qj, kj, vj, causal=causal)
    assert got.dtype == qt.dtype and got.shape == (b, t, h, hd)
    close(got, want, TOL[dtype])


def test_flash_attention_q_offset_prefill_continuation():
    rng = np.random.default_rng(7)
    qj, qt = both(rng.standard_normal((1, 128, 2, 64)))
    (kj, kt), (vj, vt) = (both(rng.standard_normal((1, 256, 2, 64)))
                          for _ in range(2))
    got = fa_ops.flash_attention(qt, kt, vt, causal=True, q_offset=128)
    want = attention_ref(qj, kj, vj, causal=True, q_offset=128)
    close(got, want, 2e-5)


def test_flash_attention_lse_is_the_rows_logsumexp():
    """``lse`` (kept for the backward kernels) is logsumexp of the scaled,
    masked scores, as the reference kernel writes it (1e-5: float32)."""
    rng = np.random.default_rng(3)
    b, t, h, hd = 2, 96, 3, 32
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal((b, t, h, hd)))
                                    for _ in range(3))
    o, lse = fa_kernel.flash_attention_fwd(qt, kt, vt, causal=True)
    s = jnp.einsum("bqhd,bkhd->bhqk", qj, kj) * hd ** -0.5
    s = jnp.where(jnp.tril(jnp.ones((t, t), bool)), s, -1e30)
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    close(lse, jax.nn.logsumexp(s, axis=-1), 1e-5)
    close(o, attention_ref(qj, kj, vj, causal=True), 2e-5)


def test_flash_attention_reads_strided_views_without_a_fold():
    """A (B, T, H, hd) view whose heads are not adjacent in memory goes in
    as it is (the kernel folds through strides)."""
    rng = np.random.default_rng(5)
    base = torch.from_numpy(rng.standard_normal((2, 64, 3, 4, 32))
                            .astype(np.float32))
    q, k, v = base[:, :, 0], base[:, :, 1], base[:, :, 2]
    assert not q.is_contiguous()
    got = fa_ops.flash_attention(q, k, v, causal=True)
    want = attention_ref(*(jnp.asarray(x.contiguous().numpy())
                           for x in (q, k, v)), causal=True)
    close(got, want, 2e-5)


@pytest.mark.parametrize("bad, match", [
    (dict(block_q=6), "multiple of 4"),
    (dict(block_threads=48), "block_threads"),
    (dict(block_q=256, block_k=256), "shared memory"),
])
def test_flash_wrapper_refuses_bad_launch_parameters(bad, match):
    q = torch.zeros((1, 16, 2, 128))
    kw = {"block_q": 64, "block_k": 64, "block_threads": 256, **bad}
    with pytest.raises(ValueError, match=match):
        fa_kernel.flash_attention_fwd(q, q, q, **kw)


@pytest.mark.parametrize("hd, launch, match", [
    (48, {}, r"head_dim 48 is not built"),
    (32, dict(block_q=24), "block_q=24 must be a positive multiple of 16"),
    (32, dict(block_k=20), "block_k=20 must be a positive multiple of 16"),
    (32, dict(block_q=64, block_threads=256), r"2 \* block_q or block_q"),
    (192, dict(block_q=64, block_threads=64), r"2 \* block_q \(a warp per 16"),
    (32, dict(block_q=256, block_threads=512), "at most 256"),
    (32, dict(stages=5), "stages=5"),
    (128, dict(block_k=256, stages=2), "shared memory"),
])
def test_flash_bf16_build_refuses_what_its_tiles_cannot_take(hd, launch,
                                                            match):
    """The tensor-core build has templates for the repo's head_dims, tiles
    by the mma's 16 rows, gives a warp 16 or 32 query rows (32 up to hd
    128) and fits its q tile and ring in shared memory; the wrapper refuses
    anything else before the CPU branch, so the CPU sees what the card
    would refuse."""
    q = torch.zeros((1, 16, 2, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        fa_kernel.flash_attention_fwd(q, q, q, **launch)


@pytest.mark.parametrize("offset, match", [(0, None), (1, "16-byte aligned"),
                                           (8, None)])
def test_flash_bf16_build_moves_rows_in_16_byte_copies(offset, match):
    """On the card the bfloat16 kernels copy rows 16 bytes at a time: a
    view that starts off a 16-byte boundary, or strides that are not
    multiples of 8 elements, is refused before the launch."""
    flat = torch.zeros(offset + 16 * 2 * 32, dtype=torch.bfloat16)
    q = flat[offset:].view(1, 16, 2, 32)
    if match is None:
        fa_kernel._check_aligned(q, q, q)
    else:
        with pytest.raises(ValueError, match=match):
            fa_kernel._check_aligned(q, q, q)
    odd = torch.zeros((1, 16, 2, 36), dtype=torch.bfloat16)[..., :32]
    with pytest.raises(ValueError, match="multiples of 8"):
        fa_kernel._check_aligned(odd)


@pytest.mark.parametrize("dtype, args, want", [
    # float32: transposed q and k, v, scores, accumulator, carries
    (torch.float32, (64, 64, 128),
     4 * (128 * 65 * 2 + 64 * 128 + 64 * 65 + 64 * 129 + 3 * 64)),
    (torch.float32, (16, 32, 64),
     4 * (64 * 17 + 64 * 33 + 32 * 64 + 16 * 33 + 16 * 65 + 3 * 16)),
    # bfloat16: the q tile and `stages` k/v slots at a pitch of hd + 8
    (torch.bfloat16, (64, 64, 128, 2), (64 + 2 * 2 * 64) * 136 * 2),
    (torch.bfloat16, (128, 32, 96, 4), (128 + 4 * 2 * 32) * 104 * 2),
    (torch.bfloat16, (16, 256, 32, 1), (16 + 2 * 256) * 40 * 2),
])
def test_flash_smem_accounting_per_build(dtype, args, want):
    """Each build's shared memory: float32 tiles padded by one word; the
    bfloat16 q tile and ring padded by 8 elements a row (conflict-free
    ldmatrix), the scores and the accumulator in registers."""
    bq, bk, hd, *stages = args
    assert fa_kernel.smem_bytes(bq, bk, hd, dtype, *stages) == want


@pytest.mark.parametrize("hd", [64, 96, 128])
def test_flash_defaults_take_the_serving_and_training_shapes(hd):
    """Each build's launch points are valid and fit the card's 232,448
    bytes of shared memory at the prefill shape (B*H 128, T 2048) and the
    training shape (B 2, T 2048, 16 heads), for the head_dims of the repo's
    one-card configs (qwen2.5-3b and jamba 128, phi3-mini 96, 64)."""
    from repro_torch.kernels import SMEM_LIMIT_BYTES

    fwd, fwd32 = fa_ops.DEFAULTS, fa_ops.F32_DEFAULTS
    bwd, bwd32 = fa_ops.BWD_DEFAULTS, fa_ops.BWD_F32_DEFAULTS
    assert fa_kernel.smem_bytes(fwd["block_q"], fwd["block_k"], hd,
                                torch.bfloat16, fwd["stages"]) <= SMEM_LIMIT_BYTES
    assert fa_kernel.smem_bytes(fwd32["block_q"], fwd32["block_k"],
                                hd) <= SMEM_LIMIT_BYTES
    for dtype, launch in ((torch.bfloat16, bwd), (torch.float32, bwd32)):
        assert fa_kernel.smem_bytes_bwd(launch["block_q"], launch["block_k"],
                                        hd, dtype) <= SMEM_LIMIT_BYTES
    spec = ktune.get_kernel("flash_attention")
    for meta in ({"bh": 128, "tq": 2048, "tk": 2048, "hd": hd,
                  "causal": True},
                 {"bh": 2 * 16, "tq": 2048, "tk": 2048, "hd": hd,
                  "causal": True}):
        assert spec.validate(fwd, meta) is None
    # the wrappers take them (their checks run before the CPU branch)
    for dtype, f, b in ((torch.bfloat16, fwd, bwd),
                        (torch.float32, fwd32, bwd32)):
        q = torch.zeros((1, 40, 2, hd), dtype=dtype)
        o, lse = fa_kernel.flash_attention_fwd(q, q, q, **f)
        fa_kernel.flash_attention_bwd(q, q, q, o, lse, q, **b)


@pytest.mark.parametrize("hd", [32, 64, 96, 128, 192])
def test_flash_wrapper_fits_its_defaults_to_the_head_dim(hd):
    """The wrapper's bfloat16 defaults pass the build's checks at every
    head_dim the repo's configs carry (at hd 192, nemotron-4's, a warp
    takes 16 rows: 256 threads for 128 rows), and the call gives its plain
    version's output; below hd 192 the defaults are kept."""
    fit = fa_ops.fit_launch(fa_ops.DEFAULTS, torch.bfloat16, hd)
    if hd <= fa_kernel.MAX_HD_TWO_TILES:
        assert fit == fa_ops.DEFAULTS
    else:
        assert fit == {**fa_ops.DEFAULTS, "block_threads": 256}
    assert fa_ops.fit_launch(fa_ops.F32_DEFAULTS, torch.float32,
                             hd) == fa_ops.F32_DEFAULTS
    gen = torch.Generator().manual_seed(hd)
    q, k, v = (torch.randn((2, 37, 3, hd), generator=gen).bfloat16()
               for _ in range(3))
    got = fa_ops.flash_attention(q, k, v, causal=True)
    want, _ = fa_kernel.flash_attention_fwd_plain(q, k, v, causal=True)
    assert torch.equal(got, want)


@pytest.mark.parametrize("hd", [64, 96, 128])
def test_flash_space_keeps_64_points(hd):
    """The bfloat16 build's space at the prefill shape holds at least 64
    valid points for every one-card head_dim, its default among them."""
    spec = ktune.get_kernel("flash_attention")
    meta = dict(spec.default_shape, hd=hd)
    space = spec.space(meta)
    assert space.names == ("block_q", "block_k", "block_threads", "stages")
    valid = [c for c in space.enumerate() if spec.validate(c, meta) is None]
    assert len(valid) >= 64
    assert spec.default_config(space, meta) == dict(spec.defaults)
    assert {c["block_threads"] * 16 // c["block_q"] for c in valid} == {
        32, 16}                                  # 16 and 32 rows a warp


@pytest.mark.parametrize("which, hd", [("fwd", 48), ("fwd", 80),
                                       ("bwd", 48)])
def test_an_unbuilt_head_dim_is_refused_before_launch(which, hd,
                                                      monkeypatch):
    """A bfloat16 head_dim with no template is a ValueError that names it,
    raised before the library is built or a launch is counted: on a tensor
    off the CPU as on the CPU."""
    def no_build(*a, **k):
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(fa_kernel, "_library", no_build)
    monkeypatch.setattr(fa_kernel, "_library_bwd", no_build)
    before = (fa_kernel.flash_attention_fwd.launches,
              fa_kernel.flash_attention_bwd.launches)
    for device in ("cpu", "meta"):
        q = torch.zeros((1, 16, 2, hd), dtype=torch.bfloat16, device=device)
        with pytest.raises(ValueError, match=f"head_dim {hd} is not built"):
            if which == "fwd":
                fa_kernel.flash_attention_fwd(q, q, q)
            else:
                lse = torch.zeros((1, 2, 16), device=device)
                fa_kernel.flash_attention_bwd(q, q, q, q, lse, q)
    assert (fa_kernel.flash_attention_fwd.launches,
            fa_kernel.flash_attention_bwd.launches) == before


@pytest.mark.parametrize("device", ["cpu", "meta", "cuda"])
def test_the_hd_192_bf16_backward_passes_the_wrappers_checks(device,
                                                            monkeypatch):
    """A bfloat16 backward at head_dim 192 (nemotron4's) is built: at its
    launch point (64 x 64, cut to the card's shared memory) it passes
    every check; on the CPU it returns the plain version's gradients, on
    meta (a dry run) gradients of their shapes without the library, on
    the card (a stand-in, ``helpers_torch.on_fake_card``) it goes on to
    the library, and no launch is counted before the kernel runs."""
    def reached(*a, **k):
        raise LookupError("the library was asked for")

    monkeypatch.setattr(fa_kernel, "_library_bwd", reached)
    if device == "cuda":
        monkeypatch.setattr(fa_kernel, "_delta", fake_delta)
    launch = fa_kernel.fit_bwd_launch(torch.bfloat16, 192)
    assert launch == {"block_q": 64, "block_k": 64, "block_threads": 128}
    assert fa_kernel.smem_bytes_bwd(64, 64, 192, torch.bfloat16) \
        <= fa_kernel.SMEM_LIMIT_BYTES
    before = fa_kernel.flash_attention_bwd.launches
    made = "cpu" if device == "cuda" else device
    q = torch.zeros((1, 40, 2, 192), dtype=torch.bfloat16, device=made)
    lse = torch.zeros((1, 2, 40), device=made)
    for kw in ({}, launch):
        if device == "cuda":
            with pytest.raises(LookupError, match="library"):
                on_fake_card(fa_kernel.flash_attention_bwd, q, q, q, q, lse,
                             q, q_offset=8, **kw)
        else:
            grads = fa_kernel.flash_attention_bwd(q, q, q, q, lse, q,
                                                  q_offset=8, **kw)
            assert [(g.shape, g.device.type) for g in grads] == [
                (q.shape, device)] * 3
    assert fa_kernel.flash_attention_bwd.launches == before


def test_flash_wrapper_refuses_bad_tensors():
    q = torch.zeros((1, 16, 2, 32))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_kernel.flash_attention_fwd(q.double(), q, q)
    with pytest.raises(ValueError, match="already repeated"):
        fa_kernel.flash_attention_fwd(q, q[:, :, :1], q[:, :, :1])
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        fa_kernel.flash_attention_fwd(q, q.bfloat16(), q)


# -- B4: decode attention ---------------------------------------------------------

@pytest.mark.parametrize("b,s,kv,rep,hd,length", [
    (2, 1024, 4, 4, 64, 700),
    (1, 512, 2, 8, 128, None),
    (3, 256, 1, 4, 64, 100),
    (2, 512, 8, 1, 64, 512),
    (2, 300, 4, 1, 96, 211),        # phi3-mini's head_dim
    (1, 256, 2, 4, 192, None),      # nemotron4's head_dim
])
def test_decode_attention_matches_reference(b, s, kv, rep, hd, length):
    rng = np.random.default_rng(11)
    qj, qt = both(rng.standard_normal((b, kv * rep, hd)))
    (kj, kt), (vj, vt) = (both(rng.standard_normal((b, s, kv, hd)))
                          for _ in range(2))
    got = da_ops.decode_attention(qt, kt, vt, length=length, block_s=64)
    want = decode_attention_ref(qj, kj, vj, length=length)
    assert got.dtype == torch.float32 and got.shape == (b, kv * rep, hd)
    close(got, want, 2e-5)


@pytest.mark.parametrize("splits", (1, 2, 4, 8, 16, 32, 64))
def test_fully_masked_splits_weigh_zero(splits):
    """``length`` far below the capacity, S = 999 (no split count here
    divides it): segments at or past ``length`` yield m = -1e30, l = 0,
    acc = 0, and the combine gives the reference's answer for every split
    count; the kernel's wrapper takes every split count its cluster can
    hold (up to 16) and refuses the rest."""
    rng = np.random.default_rng(13)
    b, s, kv, rep, hd, length = 2, 999, 2, 4, 32, 37
    qj, qt = both(rng.standard_normal((b, kv, rep, hd)))
    (kj, kt), (vj, vt) = (both(rng.standard_normal((b, s, kv, hd)))
                          for _ in range(2))
    acc, m, l = da_kernel.decode_partials_plain(qt, kt, vt, length,
                                                splits=splits)
    seg = da_kernel.segment_length(s, splits)
    assert acc.shape == (b, splits, kv, rep, hd) and m.shape == l.shape
    empty = torch.arange(splits) * seg >= length
    assert empty.sum() == splits - -(-length // seg)
    assert torch.all(m[:, empty] == -1e30) and torch.all(l[:, empty] == 0)
    assert torch.all(acc[:, empty] == 0)
    got = da_kernel.combine_splits(acc, m, l)
    want = decode_attention_ref(qj.reshape(b, kv * rep, hd), kj, vj,
                                length=length)
    close(got.reshape(b, kv * rep, hd), want, 2e-5)
    kw = dict(splits=splits, block_s=16, block_threads=32)
    if splits > da_kernel.MAX_SPLITS:
        with pytest.raises(ValueError, match="one cluster"):
            da_kernel.decode_attention(qt, kt, vt, length, **kw)
        return
    close(da_kernel.decode_attention(qt, kt, vt, length, **kw)
          .reshape(b, kv * rep, hd), want, 2e-5)


def test_phi3_mini_head_dim_96_serves_the_references_tokens():
    """phi3-mini's smoke config at its own head_dim (``d_model=384,
    n_heads=4, head_dim=96``): the port's ``serve_session`` on the CPU, on
    the reference's weights carried across, greedily decodes the tokens
    the reference's ``serve_session`` decodes from the same seed (float32
    compute, as the LM slice's greedy test: bf16 argmax ties would flip)."""
    import dataclasses

    from repro import configs as ref_configs
    from repro.launch.serve import serve_session as ref_serve_session
    from repro.models import LM as RefLM
    from repro_torch import configs
    from repro_torch.convert import lm_from_jax_params
    from repro_torch.launch.serve import serve_session

    cut = dict(d_model=384, n_heads=4, head_dim=96, compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_configs.get("phi3-mini-3.8b").smoke(),
                                  **cut)
    cfg = dataclasses.replace(configs.get("phi3-mini-3.8b").smoke(), **cut)
    assert cfg.head_dim == 96 and cfg.n_kv_heads == 4
    seed, kw = 3, dict(batch=2, prompt_len=8, gen=6)
    want = ref_serve_session(ref_cfg, seed=seed, **kw)["generated"]
    params = jax.tree.map(np.asarray,
                          jax.jit(RefLM(ref_cfg).init)(jax.random.PRNGKey(seed)))
    model = lm_from_jax_params(params, cfg, "cpu")
    got = serve_session(cfg, seed=seed, model=model, **kw)["generated"]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_decode_attention_bf16_cache():
    rng = np.random.default_rng(17)
    b, s, kv, rep, hd = 2, 300, 2, 8, 128
    qj, qt = both(rng.standard_normal((b, kv * rep, hd)), "bfloat16")
    (kj, kt), (vj, vt) = (both(rng.standard_normal((b, s, kv, hd)),
                               "bfloat16") for _ in range(2))
    got = da_ops.decode_attention(qt, kt, vt, length=211)
    close(got, decode_attention_ref(qj, kj, vj, length=211), 2e-2)


@pytest.mark.parametrize("rep, hd", [(8, 128), (12, 192)])
def test_decode_defaults_are_cut_to_the_cards_shared_memory(rep, hd):
    """A bfloat16 cache through the op at its defaults: the ring is cut to
    fit the card's shared memory where the head size needs it (hd 192,
    nemotron4's), and left as it is where it fits."""
    rng = np.random.default_rng(23)
    b, s, kv = 2, 300, 2
    qj, qt = both(rng.standard_normal((b, kv * rep, hd)), "bfloat16")
    (kj, kt), (vj, vt) = (both(rng.standard_normal((b, s, kv, hd)),
                               "bfloat16") for _ in range(2))
    got = da_ops.decode_attention(qt, kt, vt, length=211)
    close(got, decode_attention_ref(qj, kj, vj, length=211), 2e-2)
    fit = da_ops.fit_launch(da_ops.DEFAULTS, rep, hd, torch.bfloat16)
    assert da_kernel.smem_bytes(rep, hd, fit["block_s"], fit["block_threads"],
                                fit["stages"]) <= ktune.SMEM_LIMIT_BYTES
    assert (fit == da_ops.DEFAULTS) == (hd == 128)


@pytest.mark.parametrize("bad, match", [
    (dict(length=0), "positive int"),
    (dict(length=True), "positive int"),
    (dict(splits=0), "splits"),
    (dict(block_threads=1024), "block_threads"),
    (dict(block_s=0), "block_s"),
])
def test_decode_wrapper_refuses_bad_arguments(bad, match):
    q = torch.zeros((1, 2, 4, 32))
    k = torch.zeros((1, 64, 2, 32))
    kw = {"length": 8, "splits": 4, "block_s": 16,
          "block_threads": 64, **bad}
    length = kw.pop("length")
    with pytest.raises(ValueError, match=match):
        da_kernel.decode_attention(q, k, k, length, **kw)


def test_decode_wrapper_refuses_unsupported_shapes():
    with pytest.raises(ValueError, match="head_dim"):
        da_kernel.decode_attention(torch.zeros((1, 1, 1, 48)),
                                   torch.zeros((1, 8, 1, 48)),
                                   torch.zeros((1, 8, 1, 48)), 8)
    with pytest.raises(ValueError, match="rep=32"):
        da_kernel.decode_attention(torch.zeros((1, 1, 32, 32)),
                                   torch.zeros((1, 8, 1, 32)),
                                   torch.zeros((1, 8, 1, 32)), 8)


@pytest.mark.parametrize("splits", [3, 6, 12])
def test_decode_splits_must_fill_a_cluster(splits):
    """A group's splits form one thread block cluster: a power of two."""
    q = torch.zeros((1, 2, 4, 32))
    k = torch.zeros((1, 64, 2, 32))
    with pytest.raises(ValueError, match="power of two"):
        da_kernel.decode_attention(q, k, k, 8, splits=splits)


@pytest.mark.parametrize("dtype,args,want", [
    # bf16: the warps' rings (pitch hd + 8, k and v, 2-byte elements; their
    # float32 partials reuse them after the loop) + m and l
    (torch.bfloat16, (8, 128, 32, 128, 2), 4 * 2 * 2 * 32 * 136 * 2 + 128),
    (torch.bfloat16, (8, 128, 16, 256, 1), 8 * 1 * 2 * 16 * 136 * 2 + 128),
    (torch.bfloat16, (1, 96, 64, 64, 4), 2 * 4 * 2 * 64 * 104 * 2 + 128),
    # float32: scaled queries, a tile of scores, three carries, a warp's
    # accumulators
    (torch.float32, (8, 128, 32, 128, 2),
     4 * (8 * 128 + 8 * 32 + 3 * 8 + 4 * 8 * 128)),
    (torch.float32, (12, 192, 64, 256, 4),
     4 * (12 * 192 + 12 * 64 + 3 * 12 + 8 * 12 * 192)),
])
def test_decode_smem_accounting_per_build(dtype, args, want):
    """The Python-side shared-memory sums are the .cu file's, per build."""
    rep, hd, block_s, threads, stages = args
    assert da_kernel.smem_bytes(rep, hd, block_s, threads, stages,
                                dtype) == want


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "jamba-v0.1-52b",
                                  "phi3-mini-3.8b"])
def test_decode_defaults_fit_every_served_shape(arch):
    """The decode defaults are a valid point of the space at each served
    model's decode shape (batch 8, cache 2176), so serving never launches a
    point the space would refuse."""
    from repro_torch import configs
    cfg = configs.get(arch)
    meta = {"b": 8, "kv": cfg.n_kv_heads, "rep": cfg.n_heads // cfg.n_kv_heads,
            "hd": cfg.head_dim, "s": 2176}
    spec = ktune.get_kernel("decode_attention")
    assert spec.validate(dict(da_ops.DEFAULTS), meta) is None
    valid = [c for c in spec.space(meta).enumerate()
             if spec.validate(c, meta) is None]
    assert len(valid) >= 64


# -- launch-parameter spaces and tuning -------------------------------------------

@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_attention_spaces_at_the_serve_shapes(name):
    """At least 100 valid configurations at the serve shape, so a tune
    that trains on max(4, 5 % - 1) of the space measures at most 5 %."""
    spec = ktune.get_kernel(name)
    meta = spec.default_shape
    space = spec.space(meta)
    valid = [c for c in space.enumerate() if spec.validate(c, meta) is None]
    assert len(valid) >= 100 and len(valid) < space.size()
    assert spec.validate(spec.default_config(space, meta), meta) is None
    assert spec.default_config(space, meta) == dict(spec.defaults)
    n_train = max(4, int(0.05 * space.size()) - 1)
    assert (n_train + 1) / space.size() <= 0.05


def test_serve_shapes_are_the_models():
    """The specs' default shapes are what qwen2.5-3b at batch 8, prompt
    2048 and 128 generated tokens hands the kernels."""
    from repro_torch import configs
    cfg = configs.get("qwen2.5-3b")
    assert ktune.get_kernel("flash_attention").default_shape == {
        "bh": 8 * cfg.n_heads, "tq": 2048, "tk": 2048, "hd": cfg.head_dim,
        "causal": True}
    assert ktune.get_kernel("decode_attention").default_shape == {
        "b": 8, "kv": cfg.n_kv_heads, "rep": cfg.n_heads // cfg.n_kv_heads,
        "hd": cfg.head_dim, "s": 2048 + 128}


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", torch.bfloat16])
def test_store_key_matches_the_reference(name, dtype):
    meta = ktune.get_kernel(name).default_shape
    spelled = dtype if isinstance(dtype, str) else "bfloat16"
    assert ktune.kernel_workload(name, meta, dtype) == ref_kernel_workload(
        name, meta, spelled)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_smoke_tune_in_budget_then_from_cache(name, tmp_path):
    store = TuningStore(tmp_path / "kernels.json", devices="pinned")
    kw = dict(smoke=True, device="cpu", store=store, repeats=1,
              iterations=60, seed=0)
    out = ktune.tune_kernel(name, **kw)
    assert 0 < out.n_measured and out.measured_fraction <= 0.05
    assert out.timer.n_launch_failed == 0
    assert ktune.get_kernel(name).validate(out.best_config, out.shape) is None
    again = ktune.tune_kernel(name, **kw)
    assert again.result.from_cache and again.n_measured == 0
    assert again.best_config == out.best_config


def test_port_oracles_equal_the_references():
    """The port's ``ref.py`` oracles compute the reference's (float32,
    2e-6: the same arithmetic, summed in another order)."""
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_ref as port_decode_ref)
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref as port_attention_ref)

    rng = np.random.default_rng(19)
    (qj, qt), (kj, kt), (vj, vt) = (both(rng.standard_normal((2, 40, 2, 32)))
                                    for _ in range(3))
    close(port_attention_ref(qt, kt, vt, causal=True, q_offset=3),
          attention_ref(qj, kj, vj, causal=True, q_offset=3), 2e-6)
    qj, qt = both(rng.standard_normal((2, 8, 32)))
    (kj, kt), (vj, vt) = (both(rng.standard_normal((2, 50, 2, 32)))
                          for _ in range(2))
    close(port_decode_ref(qt, kt, vt, length=31),
          decode_attention_ref(qj, kj, vj, length=31), 2e-6)
