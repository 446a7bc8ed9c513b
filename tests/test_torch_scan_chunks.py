"""The chunk-parallel forms of kernels B8 (the RWKV-6 wkv forward's chunked
route) and B7 (the Mamba-1 selective-scan backward), and the split-lane
form of B6 (the selective-scan forward), on the CPU: their formulations in
plain PyTorch (``wkv6_fwd_chunked_plain``, ``selective_scan_bwd_chunked_plain``,
``selective_scan_fwd_plain`` with ``split``) held against the JAX package's
oracles (``wkv6_ref``; ``selective_scan_ref`` and ``jax.vjp`` of it) on the
same numpy-seeded inputs, at every chunk or split of the new launch
spaces, ragged T and T = 1, non-zero states, and decays that underflow;
plus the routes, launch rules and defaults the kernels follow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ref import selective_scan_ref
from repro.kernels.rwkv6_wkv.ref import wkv6_ref
from repro_torch.kernels.mamba_scan import kernel as ms_kernel
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.rwkv6_wkv import kernel as wkv_kernel
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.tune import kernels as ktune
from repro_torch.tune.kernels import specs

# the reference's kernel tests' float32 gates (tests/test_kernels.py): the
# forward atol 2e-5 / rtol 2e-4, the backward atol 1e-5 / rtol 1e-4 (the
# same recurrences, summed in another order)
FWD_TOL = (2e-5, 2e-4)
BWD_TOL = (1e-5, 1e-4)
SCAN_NAMES = ("dx", "ddelta", "dA", "dB", "dC", "dD", "dh0")


def wkv_arrays(b, t, h, hd, seed=0, decay=None):
    """r, k, v ~ N(0, 0.25), w = sigmoid(N(0, 1) + 2), u ~ N(0, 0.01), s0 ~
    N(0, 1).  ``decay`` redraws w: "tiny" (a quarter of the channels
    10^U(-30, -6), some exactly 0), "underflow" (w = exp(-exp(N + 4)):
    every product of a few dozen underflows to 0, some w are 0 already)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, hd)) * 0.5 for _ in range(3)]
    w = 1 / (1 + np.exp(-(rng.standard_normal((b, t, h, hd)) + 2)))
    if decay == "tiny":
        w[..., ::4] = 10.0 ** rng.uniform(-30, -6, w[..., ::4].shape)
        w[..., 1::7] = 0.0
    elif decay == "underflow":
        w = np.exp(-np.exp(rng.standard_normal(w.shape) + 4))
        w[..., 1::5] = 0.0
    arrs += [w, rng.standard_normal((h, hd)) * 0.1,
             rng.standard_normal((b, h, hd, hd))]
    return [np.asarray(a, np.float32) for a in arrs]


def scan_arrays(bt, t, di, s, seed=0, underflow=False):
    """x ~ N, delta = |N| * 0.1, A = -(|N| + 0.5), B, C, D, h0 ~ N, and the
    cotangents dy, dh_T ~ N.  ``underflow``: a quarter of the channels take
    delta = 1 + |N| * 0.1 and A = -(|N| + 110), so delta * A < -104 and
    a_t = exp(delta A) is 0 in float32."""
    rng = np.random.default_rng(seed)
    delta = np.abs(rng.standard_normal((bt, t, di))) * 0.1
    a = -(np.abs(rng.standard_normal((di, s))) + 0.5)
    if underflow:
        delta[..., ::4] += 1.0
        a[::4] -= 110.0
    arrs = [rng.standard_normal((bt, t, di)), delta, a,
            rng.standard_normal((bt, t, s)), rng.standard_normal((bt, t, s)),
            rng.standard_normal(di), rng.standard_normal((bt, di, s)),
            rng.standard_normal((bt, t, di)), rng.standard_normal((bt, di, s))]
    return [np.asarray(a, np.float32) for a in arrs]


def tensors(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def close(got, want, tol, what=""):
    atol, rtol = tol
    for name, g, w in zip(what or range(len(want)), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=rtol, err_msg=str(name))


# -- B8: the wkv forward's chunked route ----------------------------------------

@pytest.mark.parametrize("hd", wkv_kernel.CHUNKED_HEAD_DIMS)
@pytest.mark.parametrize("chunk", wkv_kernel.CHUNKS)
def test_wkv6_fwd_chunked_plain_matches_the_reference(hd, chunk):
    """Every head size the chunked route is built for at every chunk of
    its space, from a non-zero s0, at a T (77) no chunk divides."""
    arrays = wkv_arrays(2, 77, 2, hd, seed=hd + chunk)
    got = wkv_kernel.wkv6_fwd_chunked_plain(*tensors(arrays), chunk=chunk)
    close(got, wkv6_ref(*(jnp.asarray(a) for a in arrays)), FWD_TOL)


@pytest.mark.parametrize("t", [1, 5, 16, 33, 130])
def test_wkv6_fwd_chunked_plain_at_ragged_t_and_one_token(t):
    """T = 1, T shorter than the chunk, a whole chunk, one past it, and
    several chunks with a ragged end."""
    arrays = wkv_arrays(1, t, 3, 32, seed=t)
    got = wkv_kernel.wkv6_fwd_chunked_plain(*tensors(arrays), chunk=16)
    close(got, wkv6_ref(*(jnp.asarray(a) for a in arrays)), FWD_TOL)


@pytest.mark.parametrize("decay,chunk", [("tiny", 16), ("tiny", 64),
                                         ("underflow", 32)])
def test_wkv6_fwd_chunked_plain_takes_any_decay(decay, chunk):
    """Decays down to 1e-30 and 0, and decays whose products underflow
    after a few tokens: the chunked form (only products of w) stays finite
    and gives the serial oracle's and the reference's function, where the
    matrix form's exp(-cumsum(log w)) would overflow."""
    arrays = wkv_arrays(2, 100, 2, 64, seed=7, decay=decay)
    serial = wkv_kernel.wkv6_fwd_plain(*tensors(arrays))
    got = wkv_kernel.wkv6_fwd_chunked_plain(*tensors(arrays), chunk=chunk)
    assert all(torch.isfinite(x).all() for x in serial + got)
    close(got, serial, FWD_TOL)
    close(got, wkv6_ref(*(jnp.asarray(a) for a in arrays)), FWD_TOL)


def test_wkv6_routes():
    """Decode and any T shorter than the chunk take the serial route, as
    does a head size the chunked route is not built for; T that fills a
    chunk takes the chunked route.  The wrapper refuses chunked launch
    parameters the kernels do not take on either route."""
    assert wkv_kernel.route_of(1, 64, 8) == "serial"
    assert wkv_kernel.route_of(15, 64, 16) == "serial"
    assert wkv_kernel.route_of(16, 64, 16) == "chunked"
    assert wkv_kernel.route_of(2048, 64, 64) == "chunked"
    assert wkv_kernel.route_of(2048, 24, 16) == "serial"
    assert wkv_kernel.route_of(2048, 48, 16) == "chunked"
    assert wkv_kernel.launch_error(2048, 4, 48, 16, 4, 32, 1) == \
        "cols=32 does not divide hd=48"
    assert wkv_kernel.launch_error(1, 4, 48, 16, 4, 32, 1) is None
    assert wkv_kernel.launch_error(2048, 32, 64, 16, 4, 16, 1) is None
    assert wkv_kernel.launch_error(2048, 32, 64, 16, 1, 16, 4) is None
    assert "must divide H" in wkv_kernel.launch_error(2048, 6, 64, 16, 1,
                                                      16, 4)
    assert "threads" in wkv_kernel.launch_error(2048, 32, 16, 16, 1, 16, 1)
    assert "threads" in wkv_kernel.launch_error(2048, 32, 48, 16, 1, 16, 1)
    assert wkv_kernel.SERIAL_LAUNCH == {"chunk": 32, "block_h": 1,
                                        "split": 4}
    assert wkv_kernel.serial_launch(16, 1)["split"] == 4
    assert wkv_kernel.wkv6_fwd.program_launches.keys() == {
        "serial", "states", "chunks"}


def test_wkv6_defaults_are_the_chunked_routes_at_the_model_shapes():
    """The ops' defaults are a valid point of the space at RWKV-6's prefill
    and training shape and at the reference spec's hd 48, and the
    wrapper's CPU branch is the serial oracle for both routes."""
    spec = ktune.get_kernel("rwkv6_wkv")
    for meta in (spec.default_shape, {"b": 2, "t": 300, "h": 4, "hd": 48}):
        assert spec.validate(dict(wkv_ops.DEFAULTS), meta) is None
    args = tensors(wkv_arrays(1, 40, 2, 16, seed=2))
    for chunk in (16, 64):                 # chunked, then serial
        y, s = wkv_kernel.wkv6_fwd(*args, chunk=chunk)
        y0, s_0 = wkv_kernel.wkv6_fwd_plain(*args)
        assert torch.equal(y, y0) and torch.equal(s, s_0)


# -- B6: the selective-scan forward's split-lane form ----------------------------

def scan_fwd(arrays, split):
    """The forward's formulation (y_t's sum over the state in ``split``
    parts folded by halves) and the reference on the same inputs."""
    x, dl, a, b, c, d, h0 = arrays[:7]
    got = ms_kernel.selective_scan_fwd_plain(*tensors(arrays[:7]), split=split)
    want = selective_scan_ref(*(jnp.asarray(m) for m in (x, dl, a, b, c, d,
                                                         h0)))
    return got, want


SPLITS_BY_S = [(s, split) for s in ms_kernel.STATE_SIZES
               for split in ms_kernel.bwd_splits(s)]


@pytest.mark.parametrize("s,split", SPLITS_BY_S)
def test_selective_scan_fwd_split_form_matches_the_reference(s, split):
    """Every split the forward is built for at S 4, 8 and 16 (all of the
    space's splits at S 16), from a non-zero state, at a ragged T."""
    assert set(ms_kernel.bwd_splits(16)) == set(specs.SCAN_SPLITS)
    got, want = scan_fwd(scan_arrays(2, 45, 24, s, seed=s + split), split)
    close(got, want, FWD_TOL, ("y", "h_T"))


@pytest.mark.parametrize("t,split", [(1, 1), (1, 16), (7, 4), (33, 8)])
def test_selective_scan_fwd_split_form_at_one_token_and_ragged_t(t, split):
    got, want = scan_fwd(scan_arrays(2, t, 32, 16, seed=t), split)
    close(got, want, FWD_TOL, ("y", "h_T"))


@pytest.mark.parametrize("split", [2, 16])
def test_selective_scan_fwd_split_form_takes_underflowing_decays(split):
    """A quarter of the channels with a_t = 0 in float32: finite, the
    reference's."""
    arrays = scan_arrays(2, 50, 32, 16, seed=split, underflow=True)
    dl, a = torch.from_numpy(arrays[1]), torch.from_numpy(arrays[2])
    assert (torch.exp(dl[..., ::4, None] * a[::4]) == 0).all()
    got, want = scan_fwd(arrays, split)
    assert all(torch.isfinite(g).all() for g in got)
    close(got, want, FWD_TOL, ("y", "h_T"))


def test_selective_scan_fwd_split_sum_order():
    """The kernel's order of y_t's sum, exactly: each part's S / split
    entries in order, then the parts folded by halves (part i with part
    i + split / 2: the butterfly's pairs).  float32 values whose sums
    round make every order give other bits."""
    vals = [1.0, 0.5, 3.0, 1e8, 2.0, 2.0, 2.0, -1e8]
    p = [torch.tensor(v, dtype=torch.float32) for v in vals]
    want = {
        1: ((((((p[0] + p[1]) + p[2]) + p[3]) + p[4]) + p[5]) + p[6]) + p[7],
        2: (((p[0] + p[1]) + p[2]) + p[3]) + (((p[4] + p[5]) + p[6]) + p[7]),
        4: ((p[0] + p[1]) + (p[4] + p[5])) + ((p[2] + p[3]) + (p[6] + p[7])),
        8: ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7])),
    }
    assert len({float(w) for w in want.values()}) == 4
    prod = torch.tensor([vals], dtype=torch.float32)
    for split, w in want.items():
        assert torch.equal(ms_kernel._split_sum(prod, split), w.reshape(1))


def test_selective_scan_fwd_defaults_follow_the_shape():
    """``ops.defaults``: a thread a channel where B * dI fills the card
    (the Jamba prefill shape, B 8: ``DEFAULTS``), four at the training
    shape (B 2), more as B * dI shrinks, never more than the
    state entries; 128 threads a block (256 once block_d reaches 16); every
    default a valid point of its space, and the spec's default there."""
    spec = ktune.get_kernel("mamba_scan")
    prefill = dict(spec.default_shape)
    train = {**prefill, "bt": 2}
    assert ms_ops.defaults(prefill) == ms_ops.DEFAULTS
    assert ms_ops.DEFAULTS["split"] == 1
    assert spec.default_config(spec.space(prefill)) == ms_ops.DEFAULTS
    assert ms_ops.defaults(train) == {"block_d": 32, "chunk": 64, "split": 4}
    small = {**train, "di": 64}
    assert ms_ops.defaults(small)["split"] == 16
    assert ms_ops.defaults({**small, "s": 4})["split"] == 4
    for meta in (prefill, train, small, {**small, "s": 4}):
        cfg = ms_ops.defaults(meta)
        assert cfg["split"] <= meta["s"]
        assert cfg["block_d"] * cfg["split"] in (128, 256)
        assert ms_kernel.launch_error(meta["s"], **cfg) is None
        assert spec.validate(cfg, meta) is None
        assert spec.default_config(spec.space(meta), meta) == cfg


# -- B7: the selective-scan backward's chunk-parallel form -----------------------

def vjp(arrays):
    *primals, dy, dh = (jnp.asarray(a) for a in arrays)
    _, pullback = jax.vjp(selective_scan_ref, *primals)
    return [np.asarray(g) for g in pullback((dy, dh))]


@pytest.mark.parametrize("chunk", ms_kernel.BWD_CHUNKS)
@pytest.mark.parametrize("bt,t,di,s", [(2, 77, 32, 16), (1, 64, 48, 8),
                                       (2, 40, 16, 4)])
def test_selective_scan_bwd_chunked_plain_matches_the_vjp(bt, t, di, s,
                                                          chunk):
    """Every chunk of the space at every state size built, from non-zero
    states and cotangents, at ragged T."""
    arrays = scan_arrays(bt, t, di, s, seed=chunk + s)
    got = ms_kernel.selective_scan_bwd_chunked_plain(*tensors(arrays),
                                                     chunk=chunk)
    close(got, vjp(arrays), BWD_TOL, SCAN_NAMES)


@pytest.mark.parametrize("t,chunk", [(1, 8), (1, 64), (7, 8), (100, 16)])
def test_selective_scan_bwd_chunked_plain_at_one_token_and_ragged_t(t, chunk):
    arrays = scan_arrays(2, t, 32, 8, seed=t)
    got = ms_kernel.selective_scan_bwd_chunked_plain(*tensors(arrays),
                                                     chunk=chunk)
    close(got, vjp(arrays), BWD_TOL, SCAN_NAMES)


@pytest.mark.parametrize("chunk", [8, 32])
def test_selective_scan_bwd_chunked_plain_takes_underflowing_decays(chunk):
    """A quarter of the channels with delta * A < -104 (a_t = 0 in
    float32): finite gradients, the serial oracle's and the reference's."""
    arrays = scan_arrays(2, 50, 32, 16, seed=chunk, underflow=True)
    dl, a = torch.from_numpy(arrays[1]), torch.from_numpy(arrays[2])
    assert (torch.exp(dl[..., ::4, None] * a[::4]) == 0).all()
    got = ms_kernel.selective_scan_bwd_chunked_plain(*tensors(arrays),
                                                     chunk=chunk)
    assert all(torch.isfinite(g).all() for g in got)
    serial = ms_kernel.selective_scan_bwd_plain(*tensors(arrays), chunk=chunk)
    close(got, serial, BWD_TOL, SCAN_NAMES)
    close(got, vjp(arrays), BWD_TOL, SCAN_NAMES)


@pytest.mark.parametrize("s,chunk,split,block_d,why", [
    (16, 16, 2, 32, "kept values"),        # 16 x (8 + 1) = 144 > 80
    (16, 32, 4, 32, "kept values"),
    (16, 16, 4, 32, None),                 # 16 x (4 + 1) = 80
    (16, 16, 4, 128, "up to 256"),         # 512 threads
    (16, 8, 8, 32, None),
    (4, 32, 4, 32, None),
    (16, 12, 8, 32, "not built"),
    (8, 16, 16, 32, "split=16 not in"),
])
def test_selective_scan_bwd_launch_rules(s, chunk, split, block_d, why):
    """The chunk program keeps chunk x S / split floats of each of
    a_t h_{t-1} and a_t and two per-token sums a thread in registers:
    chunk x (S / split + 1) at most 80; a block is a multiple of 32 threads
    up to 256."""
    err = ms_kernel.bwd_launch_error(s, block_d, chunk, split, 1)
    assert (err is None) if why is None else (why in err)


@pytest.mark.parametrize("span", ms_kernel.BWD_SPANS)
def test_selective_scan_bwd_chunked_plain_at_every_span(span):
    """Every span of the space (chunks whose summaries only the chunk
    program sees), with a ragged last span and chunk."""
    arrays = scan_arrays(1, 90, 16, 8, seed=span)
    got = ms_kernel.selective_scan_bwd_chunked_plain(*tensors(arrays),
                                                     chunk=8, span=span)
    close(got, vjp(arrays), BWD_TOL, SCAN_NAMES)


def test_selective_scan_bwd_programs_and_defaults():
    """Three programs counted apart; the defaults are a launch the kernel
    takes at every state size built, and a valid point of the space at the
    Jamba training shape."""
    assert ms_kernel.selective_scan_bwd.program_launches.keys() == {
        "summaries", "carry", "chunks"}
    for s in ms_kernel.STATE_SIZES:
        cfg = ms_ops.bwd_defaults(s)
        assert ms_kernel.bwd_launch_error(s, cfg["block_d"], cfg["chunk"],
                                          cfg["split"], cfg["span"]) is None
    spec = ktune.get_kernel("mamba_scan_bwd")
    assert spec.validate(dict(ms_ops.BWD_DEFAULTS), spec.default_shape) is None
