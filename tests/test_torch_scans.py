"""Kernels B6 (Mamba-1 selective scan) and B8 (RWKV-6 wkv) of the port, on
the CPU (their plain PyTorch versions), held against the JAX package's
oracles on the same numpy-seeded inputs; plus their launch-parameter
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
from helpers_torch import on_fake_card

# the reference's kernel tests' float32 gate (tests/test_kernels.py): the
# same recurrence, summed in another order
ATOL, RTOL = 2e-5, 2e-4


def both(arr: np.ndarray):
    """One numpy array as a float32 JAX array and a float32 CPU tensor."""
    arr = np.asarray(arr, np.float32)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


def close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=ATOL, rtol=RTOL)


def wkv_inputs(b, t, h, hd, seed=0, s0=False):
    """The reference tests' distributions: r, k, v ~ N(0, 0.25), w =
    sigmoid(N(0, 1) + 2), u ~ N(0, 0.01); s0 zeros or N(0, 1)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, hd)) * 0.5 for _ in range(3)]
    arrs.append(1 / (1 + np.exp(-(rng.standard_normal((b, t, h, hd)) + 2))))
    arrs.append(rng.standard_normal((h, hd)) * 0.1)
    arrs.append(rng.standard_normal((b, h, hd, hd)) if s0
                else np.zeros((b, h, hd, hd)))
    pairs = [both(a) for a in arrs]
    return [j for j, _ in pairs], [t_ for _, t_ in pairs]


def scan_inputs(bt, t, di, s, seed=0, h0=False):
    """x ~ N(0, 1), delta = |N(0, 0.01)|, A = -(|N| + 0.5), B, C, D ~ N;
    h0 zeros or N(0, 1)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((bt, t, di)),
            np.abs(rng.standard_normal((bt, t, di))) * 0.1,
            -(np.abs(rng.standard_normal((di, s))) + 0.5),
            rng.standard_normal((bt, t, s)), rng.standard_normal((bt, t, s)),
            rng.standard_normal(di),
            rng.standard_normal((bt, di, s)) if h0 else np.zeros((bt, di, s))]
    pairs = [both(a) for a in arrs]
    return [j for j, _ in pairs], [t_ for _, t_ in pairs]


# -- B8: wkv6 ------------------------------------------------------------------

def wkv_route(route, r, k, v, w, u, s0=None, *, chunk):
    """One of the kernel's two routes on the CPU: "serial" through the
    wrapper (its CPU branch, the serial plain version), "chunked" through
    the chunked route's formulation (``wkv6_fwd_chunked_plain``)."""
    if route == "serial":
        return wkv_ops.wkv6(r, k, v, w, u, s0, chunk=chunk)
    if s0 is None:
        b, _, h, hd = r.shape
        s0 = torch.zeros((b, h, hd, hd))
    return wkv_kernel.wkv6_fwd_chunked_plain(r, k, v, w, u, s0, chunk=chunk)


@pytest.mark.parametrize("b,t,h,hd,chunk", [
    (2, 128, 2, 32, 32), (1, 96, 1, 64, 16), (2, 64, 4, 16, 64),
])
@pytest.mark.parametrize("route", ["serial", "chunked"])
def test_wkv6_matches_reference(b, t, h, hd, chunk, route):
    """The reference's test shapes (tests/test_kernels.py), in the serial
    route and in the chunked route's formulation."""
    jin, tin = wkv_inputs(b, t, h, hd)
    assert wkv_kernel.route_of(t, hd, chunk) == "chunked"
    y, s = wkv_route(route, *tin[:5], chunk=chunk)
    ye, se = wkv6_ref(*jin[:5])
    close(y, ye)
    close(s, se)


def test_wkv6_chunked_matches_serial_at_every_chunk_size():
    """Every chunk the space allows at this shape gives the serial
    program's function; t = 128 is cut into whole and ragged chunks."""
    b, t, h, hd = 2, 128, 2, 32
    _, (r, k, v, w, u, s0) = wkv_inputs(b, t, h, hd, s0=True)
    y0, s_0 = wkv_ops.wkv6(r, k, v, w, u, s0)
    spec = ktune.get_kernel("rwkv6_wkv")
    meta = {"b": b, "t": t, "h": h, "hd": hd}
    space = spec.space(meta)
    allowed = {c["chunk"] for c in space.enumerate()
               if spec.validate(c, meta) is None}
    assert allowed == {c for c in wkv_kernel.CHUNKS if c <= t}
    for chunk in sorted(allowed):
        y, s = wkv_kernel.wkv6_fwd_chunked_plain(r, k, v, w, u, s0,
                                                 chunk=chunk)
        np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{chunk}")
        np.testing.assert_allclose(s.numpy(), s_0.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{chunk}")


@pytest.mark.parametrize("route", ["serial", "chunked"])
def test_wkv6_resume_state_equals_full_run(route):
    """[0:T/2] then [T/2:T] from the carried state == the full run; and so
    for T = 1 steps (decode, the serial route whatever the chunk) from the
    prefill's state."""
    b, t, h, hd = 1, 64, 2, 16
    _, (r, k, v, w, u, s0) = wkv_inputs(b, t, h, hd)
    y_full, s_full = wkv_route(route, r, k, v, w, u, chunk=16)
    half = t // 2
    y1, s1 = wkv_route(route, *(x[:, :half] for x in (r, k, v, w)), u,
                       chunk=16)
    ys, s = [y1], s1
    assert wkv_kernel.route_of(1, hd, 16) == "serial"
    for i in range(half, t):
        y, s = wkv_ops.wkv6(*(x[:, i:i + 1] for x in (r, k, v, w)), u, s,
                            chunk=16)
        ys.append(y)
    close(torch.cat(ys, dim=1), y_full.numpy())
    close(s, s_full.numpy())


@pytest.mark.parametrize("t,chunk,route", [(1, 64, "serial"),
                                            (1, 16, "chunked"),
                                            (77, 32, "serial"),
                                            (77, 16, "chunked"),
                                            (77, 32, "chunked")])
def test_wkv6_decode_step_and_ragged_t(t, chunk, route):
    """T = 1 (a decode step) and a T the chunk does not divide, from a
    non-zero state, against the reference."""
    jin, tin = wkv_inputs(2, t, 2, 32, seed=3, s0=True)
    y, s = wkv_route(route, *tin, chunk=chunk)
    ye, se = wkv6_ref(*jin)
    close(y, ye)
    close(s, se)


# -- B6: selective scan ------------------------------------------------------------

def scan_forms(split, x, dl, a, b, c, d, h0=None, **launch) -> dict:
    """(y, h_T) at ``split`` in both of the CPU's forms: the wrapper (its
    launch rules at that split; its CPU branch the serial oracle) and the
    kernel's formulation (``selective_scan_fwd_plain`` with ``split``: y_t's
    sum over the state in the kernel's order)."""
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2], a.shape[1]))
    return {"wrapper": ms_ops.selective_scan(x, dl, a, b, c, d, h0,
                                             split=split, **launch),
            "kernel order": ms_kernel.selective_scan_fwd_plain(
                x, dl, a, b, c, d, h0, split=split)}


@pytest.mark.parametrize("bt,t,di,s,block_d,chunk", [
    (2, 64, 128, 8, 64, 16), (1, 128, 64, 16, 64, 32), (3, 32, 96, 4, 32, 8),
])
@pytest.mark.parametrize("split", [1, 4])
def test_selective_scan_matches_reference(bt, t, di, s, block_d, chunk,
                                          split):
    jin, tin = scan_inputs(bt, t, di, s)
    ye, he = selective_scan_ref(*jin[:6])
    for y, h in scan_forms(split, *tin[:6], block_d=block_d,
                           chunk=chunk).values():
        close(y, ye)
        close(h, he)


def test_selective_scan_chunked_matches_serial_at_every_chunk_size():
    """Every (block_d, chunk, split) the space allows at this shape is one
    the kernel's own rules take, and y_t's sum in the kernel's order at
    each of its splits gives the serial oracle's function; the staged
    chunk changes no arithmetic."""
    bt, t, di, s = 2, 128, 64, 4
    _, (x, dl, a, b, c, d, h0) = scan_inputs(bt, t, di, s, h0=True)
    y0, h_0 = ms_kernel.selective_scan_fwd_plain(x, dl, a, b, c, d, h0)
    spec = ktune.get_kernel("mamba_scan")
    meta = {"bt": bt, "t": t, "di": di, "s": s}
    space = spec.space(meta)
    allowed = [cfg for cfg in space.enumerate()
               if spec.validate(cfg, meta) is None]
    assert {cfg["chunk"] for cfg in allowed} == {8, 16, 32, 64}
    assert {cfg["split"] for cfg in allowed} == {1, 2, 4}
    for cfg in allowed:
        assert ms_kernel.launch_error(s, **cfg) is None, cfg
    for split in sorted({cfg["split"] for cfg in allowed}):
        y, h = ms_kernel.selective_scan_fwd_plain(x, dl, a, b, c, d, h0,
                                                  split=split)
        np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"split {split}")
        np.testing.assert_allclose(h.numpy(), h_0.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=f"split {split}")


@pytest.mark.parametrize("split", [1, 4])
def test_selective_scan_resume_state_equals_full_run(split):
    bt, t, di, s = 2, 64, 32, 8
    _, (x, dl, a, b, c, d, _) = scan_inputs(bt, t, di, s, seed=5)
    kw = dict(chunk=8, block_d=32)
    half = 40
    full = scan_forms(split, x, dl, a, b, c, d, **kw)
    first = scan_forms(split, x[:, :half], dl[:, :half], a, b[:, :half],
                       c[:, :half], d, **kw)
    for form, (y_full, h_full) in full.items():
        y1, h1 = first[form]
        y2, h2 = scan_forms(split, x[:, half:], dl[:, half:], a,
                            b[:, half:], c[:, half:], d, h1, **kw)[form]
        close(torch.cat([y1, y2], dim=1), y_full.numpy())
        close(h2, h_full.numpy())


@pytest.mark.parametrize("t,chunk,split", [(1, 64, 1), (1, 8, 4),
                                            (77, 32, 1), (77, 16, 2),
                                            (77, 16, 16)])
def test_selective_scan_one_token_and_ragged_t(t, chunk, split):
    jin, tin = scan_inputs(2, t, 64, 16, seed=4, h0=True)
    ye, he = selective_scan_ref(*jin)
    for y, h in scan_forms(split, *tin, chunk=chunk, block_d=32).values():
        close(y, ye)
        close(h, he)


# -- the wrappers' rules ------------------------------------------------------------

@pytest.mark.parametrize("bad, match", [
    (dict(split=16), "split=16 not in"),
    (dict(chunk=256), "shared memory"),
    (dict(chunk=12), "chunk=12 not built"),
    (dict(cols=64), "cols=64 not in"),
    (dict(block_h=3), "block_h=3 not in"),
])
def test_wkv_wrapper_refuses_bad_launch_parameters(bad, match):
    _, (r, k, v, w, u, s0) = wkv_inputs(1, 256, 4, 64)
    kw = {"chunk": 16, "split": 4, "cols": 16, "block_h": 1, **bad}
    with pytest.raises(ValueError, match=match):
        wkv_kernel.wkv6_fwd(r, k, v, w, u, s0, **kw)


def test_wkv_wrapper_refuses_bad_tensors():
    _, (r, k, v, w, u, s0) = wkv_inputs(1, 8, 2, 16)
    with pytest.raises(TypeError, match="float32"):
        wkv_kernel.wkv6_fwd(r.double(), k, v, w, u, s0)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_kernel.wkv6_fwd(r.transpose(1, 2).contiguous().transpose(1, 2),
                            k, v, w, u, s0)
    with pytest.raises(ValueError, match="u must be"):
        wkv_kernel.wkv6_fwd(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="s0 must be"):
        wkv_kernel.wkv6_fwd(r, k, v, w, u, s0[:, :1])


@pytest.mark.parametrize("bad, match", [
    (dict(block_d=24, split=1), "multiple of 32"),
    (dict(block_d=256, split=4), "threads"),
    (dict(block_d=256, chunk=256, split=2), "shared memory"),
])
def test_scan_wrapper_refuses_bad_launch_parameters(bad, match):
    _, args = scan_inputs(1, 8, 64, 16)
    kw = {"block_d": 64, "chunk": 16, "split": 4, **bad}
    with pytest.raises(ValueError, match=match):
        ms_kernel.selective_scan_fwd(*args, **kw)


def test_scan_wrapper_refuses_bad_tensors():
    _, (x, dl, a, b, c, d, h0) = scan_inputs(1, 8, 64, 8)
    with pytest.raises(TypeError, match="float32"):
        ms_kernel.selective_scan_fwd(x.bfloat16(), dl, a, b, c, d, h0)
    with pytest.raises(ValueError, match="state size 6"):
        ms_kernel.selective_scan_fwd(x, dl, a[:, :6].contiguous(),
                                     b[..., :6].contiguous(),
                                     c[..., :6].contiguous(), d,
                                     h0[..., :6].contiguous())
    with pytest.raises(ValueError, match="h0 must be"):
        ms_kernel.selective_scan_fwd(x, dl, a, b, c, d, h0[:, :1])


@pytest.mark.parametrize("which", ["wkv", "scan"])
def test_a_tensor_off_the_cpu_goes_to_the_kernel_or_raises(which,
                                                           monkeypatch):
    """The plain version is the CPU branch only: a CUDA tensor (a stand-in
    with no card behind it, ``helpers_torch.on_fake_card``) reaches the
    CUDA library, whose build is made to fail, and the wrapper raises
    instead of computing anything."""
    def no_library(name):
        raise _build.KernelBuildError(f"no {name} here")

    monkeypatch.setattr(_build, "load_library", no_library)
    if which == "wkv":
        monkeypatch.setattr(wkv_kernel, "_lib", None)
        _, args = wkv_inputs(1, 4, 2, 16)
        with pytest.raises(_build.KernelBuildError, match="rwkv6_wkv"):
            on_fake_card(wkv_kernel.wkv6_fwd, *args)
        assert wkv_kernel.wkv6_fwd.launches == 0
    else:
        monkeypatch.setattr(ms_kernel, "_lib", None)
        _, args = scan_inputs(1, 4, 64, 8)
        with pytest.raises(_build.KernelBuildError, match="mamba_scan"):
            on_fake_card(ms_kernel.selective_scan_fwd, *args)
        assert ms_kernel.selective_scan_fwd.launches == 0


def test_smem_accounting_matches_the_sources():
    """The Python-side shared-memory sums are the .cu files' sums."""
    assert wkv_kernel.smem_bytes(32, 1, 64) == 4 * (4 * 32 * 64 + 32 + 64)
    # the chunked route: the states program (two buffers of k, w, v tiles;
    # the state out, hd x (hd + 4)); its chunk program is the serial
    # program's block, min(chunk, 32) tokens staged at a time
    assert wkv_kernel.smem_bytes_states(16, 64) == 4 * (
        2 * 3 * 16 * 64 + 64 * 68)
    assert wkv_kernel.CHUNKS_STAGE == 32
    # the selective scan: per stage of its two-chunk ring, the x / y tile
    # (rows padded by 32 / split floats, at least 4), the delta tile, B_t
    # and C_t
    assert ms_kernel.STAGES == 2
    assert ms_kernel.smem_bytes(16, 64, 16, 4) == 4 * 2 * (
        16 * (64 + 8) + 16 * 64 + 2 * 16 * 16)
    assert ms_kernel.smem_bytes(16, 32, 32, 8) == 4 * 2 * (
        32 * (32 + 4) + 32 * 32 + 2 * 32 * 16)
    assert [ms_kernel.y_pad(sp) for sp in (1, 2, 4, 8, 16)] == [4, 16, 8, 4, 4]
    # the serial program's column tile and block: 4 columns a thread up to
    # 16 rows (256 threads at hd 64, split 4), fewer where the block would
    # not be whole warps
    assert wkv_kernel.serial_tile(64, 4, 1) == (4, 64)
    assert wkv_kernel.serial_tile(64, 2, 1) == (2, 64)
    assert wkv_kernel.serial_tile(64, 1, 1) == (1, 64)
    assert wkv_kernel.serial_tile(16, 4, 1) == (2, 32)    # 4 x 4 = 16
    assert wkv_kernel.serial_tile(48, 4, 1) == (2, 96)
    assert wkv_kernel.serial_tile(64, 8, 1) == (4, 128)
    assert wkv_kernel.serial_tile(64, 32, 1) is None      # hd / split = 2


# -- launch-parameter spaces, store keys and tuning ------------------------------------

@pytest.mark.parametrize("name", ["mamba_scan", "rwkv6_wkv"])
def test_scan_spaces_at_the_serve_shapes(name):
    """At least 64 valid configurations at the serve shape (the selective
    scan's also at its training shape, B 2), every split of the selective
    scan and every chunk of the wkv forward's chunked route among them,
    configurations the kernels refuse left out, and a tune that trains on
    max(4, 5 % - 1) of the space measures at most 5 %."""
    spec = ktune.get_kernel(name)
    meta = spec.default_shape
    space = spec.space(meta)
    valid = [c for c in space.enumerate() if spec.validate(c, meta) is None]
    assert len(valid) >= 64
    assert len(valid) < space.size()
    if name == "mamba_scan":
        assert {c["split"] for c in valid} == set(ms_kernel.bwd_splits(16))
        train = {**meta, "bt": 2}
        assert sum(spec.validate(c, train) is None
                   for c in space.enumerate()) >= 64
        assert all(ms_kernel.launch_error(meta["s"], **c) is None
                   for c in valid)
    else:
        # every chunk whose states program fits shared memory (256 does
        # not at hd 64)
        assert {c["chunk"] for c in valid} == {
            c for c in wkv_kernel.CHUNKS
            if wkv_kernel.smem_bytes_states(c, meta["hd"]) <= 232448}
        assert all(wkv_kernel.route_of(meta["t"], meta["hd"], c["chunk"])
                   == "chunked" for c in valid)
        # at hd 48 no 32-column states thread, at T 20 no chunk past it
        for other in ({**meta, "hd": 48}, {**meta, "t": 20}):
            assert 0 < sum(spec.validate(c, other) is None
                           for c in space.enumerate()) < space.size()
    want = spec.defaults(meta) if callable(spec.defaults) else spec.defaults
    assert spec.default_config(space, meta) == dict(want)
    n_train = max(4, int(0.05 * space.size()) - 1)
    assert (n_train + 1) / space.size() <= 0.05


def test_serve_shapes_are_the_models():
    """The specs' default shapes are what jamba-v0.1-52b's mamba layers and
    rwkv6-1.6b's time mix hand the kernels at batch 8 and a 2048-token
    prompt."""
    from repro_torch import configs
    jamba, rwkv = configs.get("jamba-v0.1-52b"), configs.get("rwkv6-1.6b")
    assert ktune.get_kernel("mamba_scan").default_shape == {
        "bt": 8, "t": 2048, "di": jamba.mamba.expand * jamba.d_model,
        "s": jamba.mamba.d_state}
    assert ktune.get_kernel("rwkv6_wkv").default_shape == {
        "b": 8, "t": 2048, "h": rwkv.d_model // rwkv.rwkv.head_dim,
        "hd": rwkv.rwkv.head_dim}


@pytest.mark.parametrize("name", ["mamba_scan", "rwkv6_wkv"])
def test_store_key_matches_the_reference(name):
    spec = ktune.get_kernel(name)
    for meta in (spec.default_shape, spec.smoke_shape):
        assert ktune.kernel_workload(name, meta, "float32") == \
            ref_kernel_workload(name, meta, "float32")
    assert spec.atol == 2e-4 and spec.rtol == 2e-3


@pytest.mark.parametrize("name", ["mamba_scan", "rwkv6_wkv"])
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


def test_tuned_call_resolves_the_stored_config(tmp_path, monkeypatch):
    """After ``configure``, ``wkv6(tuned=True)`` runs the stored launch
    parameters with zero measurements; a shape the store lacks runs the
    defaults."""
    store = TuningStore(tmp_path / "kernels.json", devices="pinned")
    out = ktune.tune_kernel("rwkv6_wkv", smoke=True, device="cpu",
                            store=store, repeats=1, iterations=40, seed=1)
    seen = []
    real = wkv_ops.wkv6_fwd

    def spy(*args, **kw):
        seen.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(wkv_ops, "wkv6_fwd", spy)
    ktune.configure(store, device="cpu")
    try:
        meta = out.shape
        _, args = wkv_inputs(meta["b"], meta["t"], meta["h"], meta["hd"])
        wkv_ops.wkv6(*args, tuned=True)
        _, args = wkv_inputs(1, 8, 1, 16)
        wkv_ops.wkv6(*args, tuned=True)
    finally:
        ktune.disable()
    assert seen[0] == out.best_config
    assert seen[1] == wkv_ops.DEFAULTS
    assert out.timer.n_measured == out.n_measured


def test_port_oracles_equal_the_references():
    """The port's ``ref.py`` oracles compute the reference's (float32,
    2e-6: the same arithmetic, summed in another order)."""
    from repro_torch.kernels.mamba_scan.ref import (
        selective_scan_ref as port_scan_ref)
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_ref as port_wkv_ref

    jin, tin = wkv_inputs(2, 20, 2, 16, seed=7, s0=True)
    for got, want in zip(port_wkv_ref(*tin), wkv6_ref(*jin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=2e-6)
    jin, tin = scan_inputs(2, 20, 16, 4, seed=7, h0=True)
    for got, want in zip(port_scan_ref(*tin), selective_scan_ref(*jin)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=2e-6)

