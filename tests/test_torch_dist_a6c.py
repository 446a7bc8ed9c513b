"""The layouts the port's A6c runs over CPU ranks, held against the
reference.

* RWKV-6 under the model axes (the wkv kernels' plain versions on a rank's
  heads) and Jamba with ``mamba_tp=True`` (the scans' on a rank's
  channels; ``in_proj`` computed on two strided ranges of its columns),
  each on (1, 2) and on (2, 2) with FSDP over data and ``seq_parallel``;
  whisper-base on (1, 2) model axes, on (1, 2) FSDP over the model axis
  and under an expert axis (no experts: nothing split): one sharded
  ``loss_and_grads``, every gradient gathered whole
  against ``jax.value_and_grad`` of the reference's loss, and each rank's
  stored blocks against the reference's leaf sliced by its own
  ``param_specs`` (``test_torch_dist_tp``'s checks and gates);
* ``serve_session`` on (1, 2) for the three: the tokens of the
  one-process session and of the reference's, the logits within 1e-5 of
  each step's largest;
* Qwen2.5-3B on (2, 2) (the model axis, FSDP over data) with
  ``grad_compression`` "int8" and "topk" and int8 moments: one
  ``train_step``'s parameters and error-feedback residual, gathered
  whole, against the reference's one-device step (the stacked leaf's
  absmax, or top-k, over the ranks' blocks);
* Qwen2.5-3B with int8 moments on (2, 1), FSDP over data, which cuts its
  (128, 256) MLP leaves into 128-wide blocks of a 256-wide quantization
  grid: three AdamW steps on the one-process port's gradients, the
  moments and parameters against the one-process port's, and the
  checkpoint's round trip of every moment.

Each mesh shape is one spawn of ranks that runs all of its cases.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.dist import compression as ref_compression
from repro.launch.serve import serve_session as ref_serve_session
from repro.models import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch.convert import _reference_leaf, lm_from_jax_params
from repro_torch.dist import sharding
from repro_torch.dist.compression import _topk_k, stack_groups
from repro_torch.launch.serve import serve_session
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import build_model
from repro_torch.optim import adamw
from helpers_dist import (compress_step_rank, grads_rank, load_ranks,
                          many_rank, moments_rank, run_ranks, tp_serve_rank)
from test_torch_dist_tp import (  # noqa: F401 (one_thread: autouse)
    LAYOUTS, cfgs, check_blocks, check_gradients, np_batch, one_thread,
    reference, torch_batch)
from test_torch_dist_sharding import CoordMesh

LAYOUTS.update({
    "model2": ((1, 2), dict(model_axes=("model",))),
    "model2_mamba": ((1, 2), dict(model_axes=("model",), mamba_tp=True)),
    "fsdp_model2": ((1, 2), dict(model_axes=(), fsdp_axes=("model",))),
    "experts_model2": ((1, 2), dict(model_axes=(), expert_axes=("model",))),
    "data2_model2_fsdp_seq": ((2, 2), dict(
        model_axes=("model",), fsdp_axes=("data",), seq_parallel=True)),
    "data2_model2_fsdp_seq_mamba": ((2, 2), dict(
        model_axes=("model",), fsdp_axes=("data",), seq_parallel=True,
        mamba_tp=True)),
})
CASES = [("rwkv6-1.6b", "model2"), ("rwkv6-1.6b", "data2_model2_fsdp_seq"),
         ("jamba-v0.1-52b", "model2_mamba"),
         ("jamba-v0.1-52b", "data2_model2_fsdp_seq_mamba"),
         ("whisper-base", "model2"), ("whisper-base", "fsdp_model2"),
         ("whisper-base", "experts_model2")]
SERVE = [("rwkv6-1.6b", "model2"), ("jamba-v0.1-52b", "model2_mamba"),
         ("whisper-base", "model2")]
SERVE_KW = dict(batch=2, prompt_len=8, gen=6, seed=0)
COMPRESS = ("int8", "topk")
COMPRESS_SCFG = dict(data_axes=("data",), model_axes=("model",),
                     fsdp_axes=("data",))
QWEN = "qwen2.5-3b"
LR = 1e-3
# the first step's update does not read the moments it quantizes, so
# int8 moments leave the reference's float32-moment step unchanged
COMPRESS_OPT = dict(learning_rate=LR, moments_dtype="int8")
MOMENT_STEPS = 3
MOMENTS_SCFG = dict(data_axes=("data",), model_axes=(), fsdp_axes=("data",))

_EXTRA: dict = {}


def serve_jobs(tmp_path_factory) -> list:
    """``tp_serve_rank``'s jobs: the reference's weights from
    ``PRNGKey(seed)`` (as its ``serve_session`` draws them)."""
    return [(f"serve_{arch}", cfgs(arch)[0], SERVE_KW,
             dict(data_axes=("data",), **LAYOUTS[lay][1]),
             str(one_process(arch, tmp_path_factory)[0]))
            for arch, lay in SERVE]


def compress_jobs(tmp) -> list:
    cfg, _ = cfgs(QWEN)
    batch = tmp / "compress_batch.pt"
    torch.save(torch_batch(np_batch(cfg)), batch)
    weights = tmp / "compress_weights.pt"
    torch.save(reference_step_model()[1].state_dict(), weights)
    return [(f"compress_{s}", cfg,
             dict(COMPRESS_SCFG, grad_compression=s), str(weights),
             str(batch), COMPRESS_OPT) for s in COMPRESS]


def spawn(shape, jobs, tmp, tmp_path_factory):
    """One spawn of a mesh shape: the gradient jobs and, on (1, 2), the
    serving jobs; on (2, 2), the compressed steps."""
    parts = [(grads_rank, jobs)]
    if shape == (1, 2):
        parts.append((tp_serve_rank, serve_jobs(tmp_path_factory)))
    else:
        parts.append((compress_step_rank, compress_jobs(tmp)))
    world = int(np.prod(shape))
    run_ranks(many_rank, world, tmp, shape=shape, axes=("data", "model"),
              args=(parts, str(tmp)), timeout=240)
    for tag, *_ in parts[1][1]:
        _EXTRA[tag] = load_ranks(tmp, world, tag)


def spawner(tmp_path_factory):
    return lambda shape, jobs, tmp: spawn(shape, jobs, tmp,
                                          tmp_path_factory)


def extra(tag: str, shape, tmp_path_factory) -> list:
    """The saved ranks of a serving or compression job, running its mesh
    shape's spawn first where no test has."""
    if tag not in _EXTRA:
        arch, lay = next(c for c in CASES if LAYOUTS[c[1]][0] == shape)
        check_gradients(arch, lay, tmp_path_factory, CASES,
                        spawner(tmp_path_factory))
    return _EXTRA[tag]


@pytest.mark.parametrize("arch, layout", CASES)
def test_sharded_gradients_match_reference(arch, layout, tmp_path_factory):
    check_gradients(arch, layout, tmp_path_factory, CASES,
                    spawner(tmp_path_factory))


@pytest.mark.parametrize("arch, layout", CASES)
def test_stored_blocks_are_reference_leaves_sliced(arch, layout,
                                                   tmp_path_factory):
    check_blocks(arch, layout, tmp_path_factory, CASES,
                 spawner(tmp_path_factory))


# -- serving ------------------------------------------------------------------

_ONE: dict = {}


def one_process(arch: str, tmp_path_factory):
    """(saved weights, the port's one-process session, the reference's
    tokens), once an arch."""
    if arch not in _ONE:
        cfg, rcfg = cfgs(arch)
        _, model, _ = reference(arch, tmp_path_factory, init=True)
        path = tmp_path_factory.mktemp(f"serve_{arch}") / "weights.pt"
        torch.save(model.state_dict(), path)
        fresh = build_model(cfg, seed=0, device="cpu")
        fresh.load_state_dict(model.state_dict())
        one = serve_session(cfg, model=fresh.cast_for_serving(),
                            return_logits=True, **SERVE_KW)
        # the reference draws the same weights from PRNGKey(seed)
        ref = ref_serve_session(rcfg, **SERVE_KW)
        _ONE[arch] = (path, one, np.asarray(ref["generated"]))
    return _ONE[arch]


@pytest.mark.parametrize("arch, layout", SERVE)
def test_sharded_session_matches_one_process_and_reference(
        arch, layout, tmp_path_factory):
    cfg, _ = cfgs(arch)
    _, one, ref = one_process(arch, tmp_path_factory)
    np.testing.assert_array_equal(one["generated"], ref)
    for r in extra(f"serve_{arch}", LAYOUTS[layout][0], tmp_path_factory):
        np.testing.assert_array_equal(r["generated"], one["generated"])
        for got, want in zip(r["logits"], one["logits"]):
            torch.testing.assert_close(got, want, rtol=0,
                                       atol=1e-5 * float(want.abs().max()))
        shapes = r["shapes"]
        if arch.startswith("rwkv"):
            # a rank's heads: r/k/v columns, u's rows, its wkv state
            assert shapes["layers.0.mixer.wr"][1] == cfg.d_model // 2
            assert shapes["layers.0.mixer.u"][0] == cfg.d_model // 64 // 2
        elif arch.startswith("jamba"):
            d_in = cfg.mamba.expand * cfg.d_model
            assert shapes["layers.0.mixer.in_proj"][1] == d_in
            assert shapes["layers.0.mixer.A_log"][0] == d_in // 2
        else:
            assert shapes["decoder.0.cross.wq"][1] == cfg.n_heads // 2
            assert shapes["decoder.0.cross.wk"][1] == cfg.n_kv_heads // 2
            assert shapes["embed.tokens"][0] == cfg.vocab_size // 2


# -- compression over sharded leaves ----------------------------------------------

_STEP: dict = {}


def reference_step_model():
    """(the reference's init from PRNGKey(0), the port's model holding
    it), Qwen2.5-3B smoke in float32."""
    if "model" not in _STEP:
        cfg, rcfg = cfgs(QWEN)
        params = RefLM(rcfg).init(jax.random.PRNGKey(0))
        _STEP["model"] = (params, lm_from_jax_params(
            jax.tree.map(np.asarray, params), cfg, "cpu"))
    return _STEP["model"]


def reference_step(scheme: str):
    """The reference's one-device step under ``scheme`` from zero
    residuals, as its ``make_train_step`` takes it (the loss's gradient,
    ``compress_with_feedback``, ``apply_updates``): (its new params and
    residual as numpy, the float32 gradient)."""
    cfg, rcfg = cfgs(QWEN)
    params, _ = reference_step_model()
    if "grads" not in _STEP:
        batch = {k: jax.numpy.asarray(v) for k, v in np_batch(cfg).items()}
        _STEP["grads"] = jax.jit(jax.grad(
            lambda p: RefLM(rcfg).loss(p, batch)[0]))(params)
    grads = _STEP["grads"]
    ocfg = ref_adamw.AdamWConfig(**COMPRESS_OPT)

    @jax.jit
    def step(params, grads):
        err = jax.tree.map(jax.numpy.zeros_like, params)
        grads, err = ref_compression.compress_with_feedback(
            grads, err, ref_compression.CompressionConfig(scheme=scheme))
        new, _ = ref_adamw.apply_updates(
            params, grads, ref_adamw.init_opt_state(params, ocfg), ocfg)
        return {"params": new, "err": err}

    return (jax.tree.map(np.asarray, step(params, grads)),
            jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("scheme", COMPRESS)
def test_compressed_step_over_sharded_leaves_matches_reference(
        scheme, tmp_path_factory):
    """int8: one absmax a stacked leaf, from the ranks' blocks; where
    ``g / scale`` sits at a half, the codes may be one apart
    (``test_torch_dist_train``'s rule).  top-k: the stacked leaf's k
    largest over the ranks' blocks; where a magnitude lies within 1e-5 of
    the leaf's largest of the k-th one, the two packages may keep
    different entries.  Either way the residual then differs by that
    entry, and AdamW's first step by up to ``lr``."""
    cfg, _ = cfgs(QWEN)
    ranks = extra(f"compress_{scheme}", (2, 2), tmp_path_factory)
    want, grads = reference_step(scheme)
    r = ranks[0]
    assert all(x["loss"] == r["loss"] for x in ranks)
    g_of = {n: _reference_leaf(grads, n, cfg) for n in r["params"]}
    near, n_all = 0, 0
    for names in stack_groups(g_of, len(cfg.group_pattern)).values():
        stacked = np.stack([g_of[n] for n in names])
        top = np.abs(stacked).max()
        if scheme == "int8":
            scale = top / 127.0
            flip = np.abs(np.abs(stacked / scale) % 1.0 - 0.5) < 2e-4
            size = 127 * scale
        else:
            mags = np.sort(np.abs(stacked).ravel())[::-1]
            kth = mags[_topk_k(mags.size, 0.25) - 1]
            flip = np.abs(np.abs(stacked) - kth) <= 1e-5 * top
            size = top
        near += int(flip.sum())
        n_all += stacked.size
        for i, name in enumerate(names):
            for have, tree, step, tol in (
                    (r["params"][name], want["params"], LR,
                     1e-5 * max(np.abs(_reference_leaf(
                         want["params"], name, cfg)).max(), 1e-3)),
                    (r["err"][name], want["err"], size, 1e-5 * size)):
                diff = np.abs(have.numpy() - _reference_leaf(tree, name, cfg))
                assert diff[~flip[i]].max(initial=0) <= tol, (scheme, name)
                assert diff[flip[i]].max(initial=0) <= step * 1.001 + tol, (
                    scheme, name)
    assert near <= 1e-3 * n_all, near


# -- int8 moments on the whole leaf's grid ----------------------------------------

def test_int8_moments_straddling_ranks_match_one_process(tmp_path):
    """Qwen2.5-3B smoke, FSDP over two data ranks: 128-wide blocks of the
    256-wide grid of its (128, 256) MLP leaves (and of its embedding's
    128-wide rows).  Three AdamW steps with int8 moments on the
    one-process port's gradients, without clipping (the update is then
    elementwise): the moments gathered whole and the parameters equal the
    one-process port's bit for bit (within
    ``test_apply_updates_matches_reference``'s int8 gate), and every
    moment survives the checkpoint's gather and slice."""
    cfg, _ = cfgs(QWEN)
    _, model = reference_step_model()
    one = build_model(cfg, seed=0, device="cpu")
    one.load_state_dict(model.state_dict())
    weights = tmp_path / "weights.pt"
    torch.save(one.state_dict(), weights)
    opt_kw = dict(learning_rate=LR, moments_dtype="int8", grad_clip=0.0)
    opt_cfg = adamw.AdamWConfig(**opt_kw)
    params = dict(one.named_parameters())
    opt = adamw.init_opt_state(params, opt_cfg)
    steps = []
    for step in range(MOMENT_STEPS):
        _, grads, _ = loss_and_grads(
            one, torch_batch(np_batch(cfg, seed=10 + step)))
        steps.append({n: g.detach().clone() for n, g in grads.items()})
        adamw.apply_updates(params, grads, opt, opt_cfg,
                            decay_mask=one.decay_mask())
    grads_path = tmp_path / "grads.pt"
    torch.save(steps, grads_path)
    job = ("moments", cfg, MOMENTS_SCFG, str(weights), str(grads_path),
           opt_kw)
    run_ranks(many_rank, 2, tmp_path, shape=(2, 1), axes=("data", "model"),
              args=([(moments_rank, [job])], str(tmp_path)), timeout=120)
    ranks = load_ranks(tmp_path, 2, "moments")
    assert all(r["round_trip"] for r in ranks)
    assert "layers.0.channel.w_in" in ranks[0]["grids"]
    got = ranks[0]
    for name, p in params.items():
        torch.testing.assert_close(got["params"][name], p.detach(), rtol=0,
                                   atol=0, msg=name)
        for part in ("m", "v"):
            have, want = got["opt"][part][name], opt[part][name]
            assert set(have) == set(want)
            for k in want:
                torch.testing.assert_close(have[k], want[k], rtol=0,
                                           atol=0, msg=f"{name} {part}")


# -- the grid's arithmetic, one process -----------------------------------------------

class Pieces(sharding.Spread):
    """A piece of a leaf cut along its last axis, its ranks' max stood in
    for by ``reduce``."""

    def __init__(self, start: int, total: int, reduce):
        super().__init__(None, ("model",), (3, total), (0, start))
        object.__setattr__(self, "reduce", reduce)

    def max_(self, t):
        return self.reduce(t)


@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("total, cuts", [
    (256, (128,)), (384, (192,)), (300, (100, 200)), (512, (256,)),
    (130, (65,)), (1000, (100, 600, 601))])
def test_grid_quantization_equals_whole_leaf(total, cuts, log):
    """A leaf cut along its last axis at ``cuts``, each piece quantized on
    the whole leaf's grid (the ranks' max of each grid block's statistic
    stood in for by a max over the pieces): the same codes as
    ``quantize_moment`` of the whole leaf, cut, the same scales, and the
    same dequantized values."""
    gen = torch.Generator().manual_seed(total)
    x = torch.randn((3, total), generator=gen) * torch.logspace(
        -6, 2, total)
    if log:
        x = x.square()
        x[0, :7] = 0.0
    whole = adamw.quantize_moment(x, log=log)
    bounds = (0,) + cuts + (total,)
    pieces = [x[:, a:b] for a, b in zip(bounds, bounds[1:])]
    seen: list = []

    def record(t):
        seen.append(t.clone())
        return t

    for a, piece in zip(bounds, pieces):
        adamw.quantize_moment(piece, log, Pieces(a, total, record))
    top = torch.stack(seen).amax(dim=0)

    def reduce(t):
        return t.copy_(top)

    for a, piece in zip(bounds, pieces):
        grid = Pieces(a, total, reduce)
        got = adamw.quantize_moment(piece, log, grid)
        torch.testing.assert_close(got["q"],
                                   whole["q"][:, a:a + piece.shape[-1]],
                                   rtol=0, atol=0)
        for k in whole:
            if k != "q":
                torch.testing.assert_close(got[k], whole[k], rtol=0, atol=0)
        torch.testing.assert_close(
            adamw.dequantize_moment(got, piece.shape, grid),
            adamw.dequantize_moment(whole, x.shape)[:, a:a + piece.shape[-1]],
            rtol=0, atol=0)


@pytest.mark.parametrize("width, straddles", [
    (256, True), (300, True), (384, True), (512, False), (1024, False)])
def test_moment_grids_only_where_blocks_straddle(width, straddles):
    """A (4, width) leaf cut along its last axis over two data ranks is
    placed on the whole leaf's grid (a ``Spread`` along that axis) only
    where a rank's block straddles a block of ``adamw.BLOCK`` columns; a
    leaf cut at multiples of it quantizes each rank's block alone, with
    no collective."""
    for coord in (0, 1):
        mesh = CoordMesh(("data", "model"), (2, 1), (coord, 0))
        rules = sharding.ShardingConfig(
            model_axes=(), fsdp_axes=("data",)).rules(mesh)
        lay = sharding.leaf_layout((4, width), (None, "data"), (None, None),
                                   mesh, ())
        grids = sharding.ParamLayout({"w": lay}, rules,
                                     "storage").moment_grids()
        assert ("w" in grids) == straddles
        if straddles:
            grid = grids["w"]
            assert grid.axes == ("data",) and grid.shape == (4, width)
            assert grid.start == (0, coord * (width // 2))
