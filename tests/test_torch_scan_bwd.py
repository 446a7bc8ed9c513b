"""Kernels B7 (the Mamba-1 selective-scan backward) and B9 (the RWKV-6 wkv
backward) of the port, on the CPU (their plain PyTorch versions), held
against ``jax.vjp`` of the JAX package's oracles on the same numpy-seeded
inputs, with non-zero initial states and state cotangents; the
``torch.autograd.Function``s that carry them; their launch-parameter
spaces, store keys and a CPU tune at the smoke shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import selective_scan_ref
from repro.kernels.rwkv6_wkv.ref import wkv6_ref
from repro.tune.kernels import kernel_workload as ref_kernel_workload
from repro_torch import _build
from repro_torch.kernels.mamba_scan import kernel as ms_kernel
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.runtime.store import TuningStore
from repro_torch.tune import kernels as ktune

# the reference's backward tests' gates (tests/test_kernels.py): float32
# atol 1e-5 / rtol 1e-4 (the same reverse recurrence, summed in another
# order); bfloat16 atol and rtol 2e-2 (inputs and gradients rounded to bf16,
# the arithmetic float32 on both sides)
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 2e-2)}
SCAN_NAMES = ("dx", "ddelta", "dA", "dB", "dC", "dD", "dh0")
WKV_NAMES = ("dr", "dk", "dv", "dw", "du", "ds0")


def scan_arrays(bt, t, di, s, seed=0):
    """The reference tests' distributions, a non-zero h0, and cotangents
    dy, dh_T ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bt, t, di)),
            np.abs(rng.standard_normal((bt, t, di))) * 0.1,
            -(np.abs(rng.standard_normal((di, s))) + 0.5),
            rng.standard_normal((bt, t, s)), rng.standard_normal((bt, t, s)),
            rng.standard_normal(di), rng.standard_normal((bt, di, s)),
            rng.standard_normal((bt, t, di)), rng.standard_normal((bt, di, s))]
    return [np.asarray(a, np.float32) for a in arrs]


def wkv_arrays(b, t, h, hd, seed=0, decay=None):
    """r, k, v ~ N(0, 0.25), w = sigmoid(N(0, 1) + 2), u ~ N(0, 0.01), a
    non-zero s0, and cotangents dy, ds_T ~ N(0, 1).  ``decay`` redraws w:
    "near_one" (1 - 10^U(-7, -2)), "tiny" (a quarter of the channels
    10^U(-30, -6)), "underflow" (w = exp(-exp(N + 4)): every product of a
    few dozen underflows to 0, some w are 0 already)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, hd)) * 0.5 for _ in range(3)]
    w = 1 / (1 + np.exp(-(rng.standard_normal((b, t, h, hd)) + 2)))
    if decay == "near_one":
        w = 1 - 10.0 ** rng.uniform(-7, -2, w.shape)
    elif decay == "tiny":
        w[..., ::4] = 10.0 ** rng.uniform(-30, -6, w[..., ::4].shape)
    elif decay == "underflow":
        w = np.exp(-np.exp(rng.standard_normal(w.shape) + 4))
        w[..., 1::5] = 0.0
    arrs.append(w)
    arrs += [rng.standard_normal((h, hd)) * 0.1,
             rng.standard_normal((b, h, hd, hd)),
             rng.standard_normal((b, t, h, hd)),
             rng.standard_normal((b, h, hd, hd))]
    return [np.asarray(a, np.float32) for a in arrs]


def vjp(ref, arrays):
    *primals, dy, ds = (jnp.asarray(a) for a in arrays)
    _, pullback = jax.vjp(ref, *primals)
    return [np.asarray(g) for g in pullback((dy, ds))]


def tensors(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def close(got, want, dtype="float32", what=""):
    atol, rtol = TOL[dtype]
    for name, g, w in zip(what, got, want):
        np.testing.assert_allclose(g.detach().float().numpy(), w, atol=atol,
                                   rtol=rtol, err_msg=name)


# -- B7: the selective-scan backward -------------------------------------------------

@pytest.mark.parametrize("bt,t,di,s,chunk", [
    (1, 16, 32, 4, 8), (2, 64, 48, 8, 16),    # the reference's float32 cases
    (2, 77, 32, 16, 16),                      # ragged T
    (1, 1, 32, 4, 8),                         # one token
])
def test_selective_scan_bwd_matches_the_vjp(bt, t, di, s, chunk):
    """The wrapper (its CPU branch, the serial plain version) at a launch
    the kernel takes (chunk x (S / split + 1) <= 80 kept values a thread:
    two threads a channel, four at S 16), and the kernel's chunk-parallel
    form at the same chunk: each the reference's vjp."""
    arrays = scan_arrays(bt, t, di, s)
    want = vjp(selective_scan_ref, arrays)
    got = ms_kernel.selective_scan_bwd(*tensors(arrays), block_d=32,
                                       chunk=chunk, split=max(2, s // 4))
    close(got, want, what=SCAN_NAMES)
    close(ms_kernel.selective_scan_bwd_chunked_plain(*tensors(arrays),
                                                     chunk=chunk),
          want, what=SCAN_NAMES)


@pytest.mark.parametrize("chunk", (1, 2, 4, 8, 16, 32, 64))
def test_selective_scan_bwd_at_every_chunk_of_the_space(chunk):
    """Every chunk the space can pick (8-64) and the shorter ones, at a T
    none of them divides but 1 (70 tokens): the serial plain version at
    spans of that length and the chunk-parallel form at chunks of it."""
    arrays = scan_arrays(1, 70, 32, 8, seed=chunk)
    want = vjp(selective_scan_ref, arrays)
    close(ms_kernel.selective_scan_bwd_plain(*tensors(arrays), chunk=chunk),
          want, what=SCAN_NAMES)
    close(ms_kernel.selective_scan_bwd_chunked_plain(*tensors(arrays),
                                                     chunk=chunk),
          want, what=SCAN_NAMES)


# -- B9: the wkv backward ------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,hd,chunk,span_chunks", [
    (1, 32, 1, 16, 8, 1), (2, 64, 2, 32, 16, 2),   # the reference's cases
    (2, 77, 2, 16, 4, 3),                          # ragged T
    (1, 1, 1, 16, 8, 4),                           # one token
])
def test_wkv6_bwd_matches_the_vjp(b, t, h, hd, chunk, span_chunks):
    """The wrapper (its CPU branch, the serial plain version) at its
    defaults, the serial plain version at spans of chunk * span_chunks
    tokens, and the kernel's chunked form at ``chunk``: each the
    reference's vjp."""
    arrays = wkv_arrays(b, t, h, hd)
    want = vjp(wkv6_ref, arrays)
    close(wkv_kernel.wkv6_bwd(*tensors(arrays), **wkv_ops.BWD_DEFAULTS),
          want, what=WKV_NAMES)
    close(wkv_kernel.wkv6_bwd_plain(*tensors(arrays),
                                    span=chunk * span_chunks), want,
          what=WKV_NAMES)
    close(wkv_kernel.wkv6_bwd_chunked_plain(*tensors(arrays), chunk=chunk),
          want, what=WKV_NAMES)


@pytest.mark.parametrize("chunk", (1, 2, 4, 8, 16, 32, 64))
def test_wkv6_bwd_at_every_chunk_of_the_space(chunk):
    """The chunked form at every chunk length the space can pick (8-64)
    and the shorter ones, and the serial plain version at spans of that
    length, at 37 tokens."""
    arrays = wkv_arrays(1, 37, 1, 16, seed=chunk)
    want = vjp(wkv6_ref, arrays)
    close(wkv_kernel.wkv6_bwd_chunked_plain(*tensors(arrays), chunk=chunk),
          want, what=WKV_NAMES)
    close(wkv_kernel.wkv6_bwd_plain(*tensors(arrays), span=chunk), want,
          what=WKV_NAMES)


@pytest.mark.parametrize("b,t,h,hd,chunk,decay", [
    (1, 32, 1, 16, 8, None), (2, 64, 2, 32, 16, None),  # the reference's
    (2, 77, 2, 16, 32, None),                           # ragged T
    (1, 1, 1, 16, 16, None),                            # one token
    (1, 64, 2, 16, 16, "near_one"),
    (2, 50, 1, 16, 16, "tiny"),
    (1, 70, 2, 32, 32, "underflow"),
    (1, 40, 1, 48, 8, None),                            # hd 48 (C5)
])
def test_wkv6_bwd_chunked_plain_matches_the_vjp(b, t, h, hd, chunk, decay):
    """The kernel's chunked formulation (every decay factor a running
    product of w's) against the reference's vjp, with w near 1, w below
    1e-6 and w that underflow to 0 after a few products: within the
    reference's float32 gate and never inf or nan."""
    arrays = wkv_arrays(b, t, h, hd, decay=decay)
    got = wkv_kernel.wkv6_bwd_chunked_plain(*tensors(arrays), chunk=chunk)
    assert all(torch.isfinite(g).all() for g in got)
    close(got, vjp(wkv6_ref, arrays), what=WKV_NAMES)


def test_wkv6_bwd_takes_head_dim_48():
    """C5 lifted: the backward is built for hd 48 (the reference spec's
    default shape), so the wrapper takes it and gives the vjp."""
    arrays = wkv_arrays(1, 20, 2, 48, seed=5)
    close(wkv_kernel.wkv6_bwd(*tensors(arrays), chunk=8, cols=16),
          vjp(wkv6_ref, arrays), what=WKV_NAMES)
    assert ktune.get_kernel("rwkv6_wkv_bwd").validate(
        {"chunk": 16, "block_threads": 256, "cols": 16, "parts": 4},
        {"b": 1, "t": 64, "h": 1, "hd": 48}) is None
    with pytest.raises(ValueError, match="cols=32"):
        wkv_kernel.wkv6_bwd(*tensors(arrays), cols=32)


# -- the autograd Functions ---------------------------------------------------------

def test_selective_scan_function_gives_the_plain_backward():
    """Gradients through ``ops.selective_scan`` (autograd recording) are
    the plain backward's, for both outputs' cotangents, h0 included; the
    forward is the forward kernel's."""
    arrays = scan_arrays(2, 20, 32, 8, seed=3)
    *primals, dy, dh = tensors(arrays)
    leaves = [p.clone().requires_grad_() for p in primals]
    y, h_t = ms_ops.selective_scan(*leaves)
    assert isinstance(y.grad_fn, ms_ops.SelectiveScan._backward_cls)
    torch.autograd.backward((y, h_t), (dy, dh))
    bwd = ms_ops.BWD_DEFAULTS
    want = ms_kernel.selective_scan_bwd_plain(*primals, dy, dh,
                                              chunk=bwd["chunk"])
    for name, leaf, w in zip(SCAN_NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name
    meta = {"bt": 2, "t": 20, "di": 32, "s": 8}
    y0, h0 = ms_kernel.selective_scan_fwd(*primals, **ms_ops.defaults(meta))
    assert torch.equal(y.detach(), y0) and torch.equal(h_t.detach(), h0)
    with torch.no_grad():
        y, _ = ms_ops.selective_scan(*leaves)
    assert y.grad_fn is None


def test_wkv6_function_gives_the_plain_backward():
    arrays = wkv_arrays(2, 20, 2, 16, seed=3)
    *primals, dy, ds = tensors(arrays)
    leaves = [p.clone().requires_grad_() for p in primals]
    y, s_t = wkv_ops.wkv6(*leaves)
    assert isinstance(y.grad_fn, wkv_ops.Wkv6._backward_cls)
    torch.autograd.backward((y, s_t), (dy, ds))
    want = wkv_kernel.wkv6_bwd_plain(*primals, dy, ds)
    for name, leaf, w in zip(WKV_NAMES, leaves, want):
        assert torch.equal(leaf.grad, w), name
    with torch.no_grad():
        y, _ = wkv_ops.wkv6(*leaves)
    assert y.grad_fn is None


@pytest.mark.parametrize("which", ["scan", "wkv"])
def test_bf16_operands_get_bf16_gradients_within_the_reference_gate(which):
    """The reference's bf16 cases: the ops compute in float32 whatever the
    operands' dtype, so the bf16 gradients are the float32 reference's on
    the bf16-rounded inputs, rounded (y.sum() + 0.5 h_T.sum(), as the
    reference's test)."""
    if which == "scan":
        arrays = scan_arrays(1, 64, 32, 4)[:6]
        op, ref, names = ms_ops.selective_scan, selective_scan_ref, SCAN_NAMES
    else:
        arrays = wkv_arrays(1, 64, 2, 16)[:5]
        op, ref, names = wkv_ops.wkv6, wkv6_ref, WKV_NAMES
    leaves = [torch.from_numpy(a).bfloat16().requires_grad_() for a in arrays]
    out, state = op(*leaves)
    (out.sum() + 0.5 * state.sum()).backward()
    rounded = [jnp.asarray(leaf.detach().float().numpy()) for leaf in leaves]

    def loss(*args):
        y, last = ref(*args)
        return y.sum() + 0.5 * last.sum()

    want = jax.grad(loss, argnums=tuple(range(len(rounded))))(*rounded)
    assert all(leaf.grad.dtype == torch.bfloat16 for leaf in leaves)
    close([leaf.grad for leaf in leaves], [np.asarray(w) for w in want],
          "bfloat16", what=names)


# -- the wrappers' checks -----------------------------------------------------------

def test_backward_wrappers_refuse_what_the_kernels_do_not_take():
    x, dl, a, b, c, d, h0, dy, dh = tensors(scan_arrays(1, 8, 64, 4))
    with pytest.raises(ValueError, match="split=8"):
        ms_kernel.selective_scan_bwd(x, dl, a, b, c, d, h0, dy, dh, split=8)
    with pytest.raises(ValueError, match="dy must be"):
        ms_kernel.selective_scan_bwd(x, dl, a, b, c, d, h0, dy[:, :4], dh)
    with pytest.raises(ValueError, match="shared memory"):
        ms_kernel.selective_scan_bwd(x, dl, a, b, c, d, h0, dy, dh,
                                     block_d=512, chunk=64, split=1)
    r, k, v, w, u, s0, dy, ds = tensors(wkv_arrays(1, 8, 2, 16))
    with pytest.raises(ValueError, match="chunk=12 not built"):
        wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dy, ds, chunk=12)
    with pytest.raises(ValueError, match="ds_t must be"):
        wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dy, ds[:, :1])
    with pytest.raises(ValueError, match="parts=5"):
        wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dy, ds, parts=5)
    with pytest.raises(ValueError, match="block_threads=1024"):
        wkv_kernel.wkv6_bwd(r, k, v, w, u, s0, dy, ds, block_threads=1024)
    r24 = torch.zeros((1, 8, 2, 24))
    with pytest.raises(ValueError, match="hd=24 not built"):
        wkv_kernel.wkv6_bwd(r24, r24, r24, r24, torch.zeros((2, 24)),
                            torch.zeros((1, 2, 24, 24)), r24,
                            torch.zeros((1, 2, 24, 24)))


@pytest.mark.parametrize("which", ["scan", "wkv"])
def test_a_tensor_off_the_cpu_goes_to_the_backward_kernel_or_raises(
        which, monkeypatch):
    """The plain backward is the CPU branch only: a tensor on another
    device (here ``meta``) reaches the CUDA library, whose build is made
    to fail, and the wrapper raises instead of computing anything."""
    def no_library(name):
        raise _build.KernelBuildError(f"no {name} here")

    monkeypatch.setattr(_build, "load_library", no_library)
    if which == "scan":
        monkeypatch.setattr(ms_kernel, "_lib_bwd", None)
        args = tensors(scan_arrays(1, 4, 64, 8))
        with pytest.raises(_build.KernelBuildError, match="mamba_scan_bwd"):
            ms_kernel.selective_scan_bwd(*(x.to("meta") for x in args))
        assert ms_kernel.selective_scan_bwd.launches == 0
    else:
        monkeypatch.setattr(wkv_kernel, "_lib_bwd", None)
        args = tensors(wkv_arrays(1, 4, 2, 16))
        with pytest.raises(_build.KernelBuildError, match="rwkv6_wkv_bwd"):
            wkv_kernel.wkv6_bwd(*(x.to("meta") for x in args))
        assert wkv_kernel.wkv6_bwd.launches == 0


def test_backward_smem_accounting_matches_the_sources():
    """The Python-side shared-memory sums are the .cu files' sums."""
    # the chunk program: two buffers of x, delta, dy (chunk x block_d) and
    # B_t, C_t (chunk x S); the span's chunks' P and h_loc (span x block_d
    # x S); the reduced dx and ddelta sums (chunk x block_d); the warps'
    # dC/dB partials (chunk x 2S); the summaries: two buffers of x, delta,
    # dy, B_t and C_t, and three (block_d x S) tiles of results
    assert ms_kernel.smem_bytes_bwd(16, 128, 16, 4, 8) == 4 * (
        2 * (3 * 16 * 128 + 2 * 16 * 16) + 2 * 8 * 128 * 16 + 2 * 16 * 128
        + 16 * 16 * 2 * 16)
    assert ms_kernel.smem_bytes_bwd_summaries(16, 128, 16) == 4 * (
        2 * (3 * 16 * 128 + 2 * 16 * 16) + 3 * 128 * 16)
    # the chunk program: ten (chunk, hd + 4) tiles, S0 and G (hd, hd + 4),
    # M and Q (chunk, chunk + 4), u, rowsum(G * S0), the bonus sums; dw's
    # two scanned terms in S0's place, or in two tiles of their own past
    # chunk hd / 2
    assert wkv_kernel.smem_bytes_bwd(16, 64) == 4 * (
        10 * 16 * 68 + 2 * 64 * 68 + 2 * 16 * 20 + 2 * 64 + 16)
    assert wkv_kernel.smem_bytes_bwd(32, 16) == 4 * (
        12 * 32 * 20 + 2 * 16 * 20 + 2 * 32 * 36 + 2 * 16 + 32)
    assert wkv_kernel.smem_bytes_bwd(64, 64) > 232448 \
        >= wkv_kernel.smem_bytes_bwd(32, 64)
    assert ms_kernel.bwd_splits(4) == (1, 2, 4)
    assert ms_kernel.bwd_splits(16) == (1, 2, 4, 8, 16)



@pytest.mark.parametrize("s", ms_kernel.STATE_SIZES)
def test_scan_backward_defaults_fit_every_state_size(s):
    """The backward's defaults are a configuration the kernel takes at
    every state size it is built for (S < 8 takes S threads a channel),
    so ``ops.selective_scan`` launches them unchanged."""
    meta = {"bt": 1, "t": 64, "di": 64, "s": s}
    cfg = ms_ops.bwd_defaults(s)
    assert cfg["split"] == min(ms_ops.BWD_DEFAULTS["split"], s)
    assert ktune.get_kernel("mamba_scan_bwd").validate(cfg, meta) is None

# -- launch-parameter spaces, store keys and tuning ------------------------------------

@pytest.mark.parametrize("name", ["mamba_scan_bwd", "rwkv6_wkv_bwd"])
def test_backward_spaces_at_the_training_shapes(name):
    """At least 64 valid configurations at the training shape, the
    defaults among them, shared memory bounding the chunk, and a tune that
    trains on max(4, 5 % - 1) of the space measures at most 5 %."""
    spec = ktune.get_kernel(name)
    meta = spec.default_shape
    space = spec.space(meta)
    valid = [c for c in space.enumerate() if spec.validate(c, meta) is None]
    assert len(valid) >= 64 and len(valid) < space.size()
    assert spec.validate(dict(spec.defaults), meta) is None
    assert spec.default_config(space, meta) == dict(spec.defaults)
    assert any("shared-memory" in (spec.validate(c, meta) or "")
               for c in space.enumerate())
    n_train = max(4, int(0.05 * space.size()) - 1)
    assert (n_train + 1) / space.size() <= 0.05


def test_training_shapes_are_the_models():
    """The backward specs' default shapes are what jamba-v0.1-52b's mamba
    layers hand the scan at batch 2 x 2048 and rwkv6-1.6b's time mix hands
    the wkv at batch 8 x 2048."""
    from repro_torch import configs
    jamba, rwkv = configs.get("jamba-v0.1-52b"), configs.get("rwkv6-1.6b")
    assert ktune.get_kernel("mamba_scan_bwd").default_shape == {
        "bt": 2, "t": 2048, "di": jamba.mamba.expand * jamba.d_model,
        "s": jamba.mamba.d_state}
    assert ktune.get_kernel("rwkv6_wkv_bwd").default_shape == {
        "b": 8, "t": 2048, "h": rwkv.d_model // rwkv.rwkv.head_dim,
        "hd": rwkv.rwkv.head_dim}


@pytest.mark.parametrize("name", ["mamba_scan_bwd", "rwkv6_wkv_bwd"])
def test_backward_store_key_matches_the_reference(name):
    spec = ktune.get_kernel(name)
    for meta in (spec.default_shape, spec.smoke_shape):
        assert ktune.kernel_workload(name, meta, "float32") == \
            ref_kernel_workload(name, meta, "float32")
    assert spec.atol == 2e-4 and spec.rtol == 2e-3


@pytest.mark.parametrize("name", ["mamba_scan_bwd", "rwkv6_wkv_bwd"])
def test_backward_smoke_tune_in_budget_then_from_cache(name, tmp_path):
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


def test_tuned_backward_resolves_the_stored_config(tmp_path, monkeypatch):
    """After ``configure``, a recorded call of ``wkv6(tuned=True)`` runs the
    backward at the stored ``rwkv6_wkv_bwd`` parameters with zero
    measurements."""
    store = TuningStore(tmp_path / "kernels.json", devices="pinned")
    out = ktune.tune_kernel("rwkv6_wkv_bwd", smoke=True, device="cpu",
                            store=store, repeats=1, iterations=40, seed=1)
    seen = []
    real = wkv_ops.wkv6_bwd

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(wkv_ops, "wkv6_bwd", spy)
    ktune.configure(store, device="cpu")
    try:
        meta = out.shape
        *primals, _, _ = tensors(wkv_arrays(meta["b"], meta["t"], meta["h"],
                                            meta["hd"]))
        leaves = [p.requires_grad_() for p in primals]
        y, _ = wkv_ops.wkv6(*leaves, tuned=True)
        y.sum().backward()
    finally:
        ktune.disable()
    assert seen == [out.best_config]
    assert out.timer.n_measured == out.n_measured
