"""Data-parallel training over CPU ranks (``repro_torch.launch.train.
train_loop(scfg=, mesh=)``) and error-feedback gradient compression in the
train step, mirroring the reference's ``tests/test_distributed.py``
(``test_sharded_train_step_matches_single_device``,
``test_elastic_remesh_restore_continues_identically``) and
``tests/test_fault_tolerance.py::test_training_with_int8_grad_compression``.

The Qwen2.5-3B smoke config, batch 8 x 32, as the reference's tests; the
1-rank runs are the port's own ``train_loop`` without a mesh.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.dist.sharding import ShardingConfig as RefShardingConfig
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.launch.steps import make_train_step
from repro.models import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro_torch import configs
from repro_torch.convert import _reference_leaf, train_state_from_jax
from repro_torch.dist.compression import init_error_state, stack_groups
from repro_torch.dist.sharding import ShardingConfig
from repro_torch.launch.steps import train_step
from repro_torch.launch.train import train_loop
from repro_torch.optim import adamw
from helpers_dist import load_ranks, run_ranks, train_rank

CFG = configs.get("qwen2.5-3b").smoke()
RUN = dict(batch=8, seq_len=32)
DP = dict(data_axes=("data",), model_axes=(), fsdp_axes=(), remat=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread in this process while its tests run, as every rank has:
    under pytest-xdist the workers share the cores, and many small
    parallel regions on oversubscribed cores run tens of times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def ranks_train(tmp_path, world, steps, scfg_kw=DP, **kw):
    run_ranks(train_rank, world, tmp_path, shape=(world,), axes=("data",),
              args=(CFG, dict(steps_total=steps, **RUN, **kw), scfg_kw,
                    str(tmp_path)), timeout=90)
    return load_ranks(tmp_path, world)


def one_rank(steps, scfg=None, **kw):
    return train_loop(CFG, steps_total=steps, **RUN, log_every=0,
                      device="cpu", scfg=scfg, **kw)


@pytest.fixture(scope="module")
def two_ranks_12(tmp_path_factory):
    return ranks_train(tmp_path_factory.mktemp("dp2"), 2, 12)


@pytest.fixture(scope="module")
def one_rank_12():
    return one_rank(12)


def test_two_ranks_match_one_rank(two_ranks_12, one_rank_12):
    for rank in two_ranks_12:
        np.testing.assert_allclose(rank["losses"], one_rank_12["losses"],
                                   rtol=2e-4, atol=2e-4)
    # the ranks hold the same parameters after every update
    a, b = two_ranks_12
    for name, p in a["params"].items():
        assert torch.equal(p, b["params"][name]), name


def test_four_ranks_fsdp_over_data_match_one_rank(tmp_path, one_rank_12):
    """FSDP over the data axis: each rank stores its ``param_specs`` block
    of every leaf (``LM.shard``), and the losses are DP's."""
    out = ranks_train(tmp_path, 4, 6, scfg_kw=dict(DP, fsdp_axes=("data",)))
    for rank in out:
        np.testing.assert_allclose(rank["losses"], one_rank_12["losses"][:6],
                                   rtol=2e-4, atol=2e-4)


def test_two_ranks_int8_compression_match_one_rank(tmp_path):
    scfg_kw = dict(DP, grad_compression="int8")
    out = ranks_train(tmp_path, 2, 6, scfg_kw=scfg_kw)
    want = one_rank(6, scfg=ShardingConfig(**scfg_kw))
    for rank in out:
        np.testing.assert_allclose(rank["losses"], want["losses"],
                                   rtol=2e-4, atol=2e-4)


def test_elastic_resume_on_one_rank_continues(tmp_path, two_ranks_12):
    """8 steps on 2 ranks (checkpoint at 4 and 8), resumed on 1 rank to
    step 12: the losses of an uninterrupted 2-rank run."""
    ckpt = tmp_path / "ckpt"
    first = ranks_train(tmp_path, 2, 8, ckpt_dir=str(ckpt), ckpt_every=4)
    assert first[0]["resumed_from"] is None
    resumed = one_rank(12, ckpt_dir=ckpt, ckpt_every=100)
    assert resumed["resumed_from"] == 8
    np.testing.assert_allclose(resumed["losses"],
                               two_ranks_12[0]["losses"][8:],
                               rtol=2e-4, atol=2e-4)


# -- the compressed step against the reference's ------------------------------------

def test_int8_train_step_matches_reference():
    cfg = dataclasses.replace(CFG, compute_dtype="float32")
    rcfg = dataclasses.replace(ref_configs.get("qwen2.5-3b").smoke(),
                               compute_dtype="float32")
    ocfg = ref_adamw.AdamWConfig(learning_rate=1e-3)
    batch = {"tokens": np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)}
    batch = {"tokens": batch["tokens"][:, :-1],
             "labels": batch["tokens"][:, 1:]}
    shapes = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          batch)
    scfg = RefShardingConfig(data_axes=("data",), model_axes=(),
                             fsdp_axes=(), grad_compression="int8")
    bundle = make_train_step(rcfg, scfg, ref_host_mesh(1), ocfg, shapes)
    params = RefLM(rcfg).init(jax.random.PRNGKey(0))
    state = {"params": params, "opt": ref_adamw.init_opt_state(params, ocfg),
             "step": jax.numpy.zeros((), jax.numpy.int32),
             "err": jax.tree.map(jax.numpy.zeros_like, params)}
    model, opt = train_state_from_jax(
        jax.tree.map(np.asarray, {k: state[k] for k in ("params", "opt",
                                                        "step")}),
        cfg, "cpu")
    err = init_error_state(dict(model.named_parameters()))
    # the reference's float32 gradient, to find the codes at exact halves
    # (before the step, which donates the state)
    grads = jax.tree.map(np.asarray, jax.grad(
        lambda p: RefLM(rcfg).loss(p, batch)[0])(params))
    new_state, metrics = bundle.jit()(state, batch)
    got = train_step(model, opt, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                     adamw.AdamWConfig(learning_rate=1e-3),
                     grad_compression="int8", err=err)
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=1e-5)
    want = jax.tree.map(np.asarray, new_state)
    at_half = 0
    g_of = {name: _reference_leaf(grads, name, cfg)
            for name, _ in model.named_parameters()}
    # one absmax scale a reference leaf: the layers of a scan slot together
    scale_of = {}
    for names in stack_groups(g_of, len(cfg.group_pattern)).values():
        top = max(np.abs(g_of[n]).max() for n in names)
        scale_of.update({n: top / 127.0 for n in names})
    for name, p in model.named_parameters():
        g, scale = g_of[name], scale_of[name]
        # where g / scale sits at a half the two float32 gradients may
        # round to codes one apart: the error then differs by one code
        # and AdamW's first step (lr * sign) by up to lr
        # (the float32 gradients agree to ~1e-6 of the largest, ~1.3e-4 of
        # a code; a window of 2e-4 holds ~4e-4 of the entries by chance)
        half = np.abs(np.abs(g / scale) % 1.0 - 0.5) < 2e-4
        at_half += int(half.sum())
        # the residual is held at the gradient's scale: the two packages'
        # absmax scales differ in the last float32 bits, moving every
        # dequantized entry by up to max|g| times that
        for have, ref_tree, step, size in (
                (p.detach(), want["params"], 1e-3, None),
                (err[name], want["err"], scale, 127 * scale)):
            ref_leaf = _reference_leaf(ref_tree, name, cfg)
            diff = np.abs(have.numpy() - ref_leaf)
            tol = 1e-5 * (max(np.abs(ref_leaf).max(), 1e-3) if size is None
                          else size)
            assert diff[~half].max(initial=0) <= tol, name
            assert diff[half].max(initial=0) <= step * 1.001 + tol, name
    n = sum(p.numel() for p in model.parameters())
    assert at_half <= 1e-3 * n, at_half


def test_training_with_int8_grad_compression():
    """The reference's gate: 25 steps, int8 error-feedback compression
    trains comparably (final losses within 0.1) and reduces the loss."""
    run = dict(batch=8, seq_len=64)
    out = train_loop(CFG, steps_total=25, **run, log_every=0, device="cpu",
                     scfg=ShardingConfig(**DP, grad_compression="int8"))
    base = train_loop(CFG, steps_total=25, **run, log_every=0, device="cpu")
    assert abs(out["final_loss"] - base["final_loss"]) < 0.1
    assert out["losses"][-1] < out["losses"][0]
    assert set(out["state"]["err"]) == set(out["state"]["params"])
