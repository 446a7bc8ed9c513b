"""The recurrent families' training path of the port on the CPU at the smoke
size: RWKV-6 1.6B's and Jamba-v0.1's reduced configs (Jamba with its experts
and without them) with the reference's weights and optimizer state carried
across (``train_state_from_jax``), held against the JAX package's
``jax.value_and_grad(LM.loss)`` (its XLA ``chunked_scan`` path) and its
AdamW steps; the decay mask and the moments over the recurrent and nested
leaves; the train CLI and the restart drill.  The scans' gradients come from
the plain versions of B7 and B9 here.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticPipeline as RefPipeline
from repro.models import LM as RefLM
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro_torch import configs
from repro_torch.convert import (_reference_leaf, lm_from_jax_params,
                                 train_state_from_jax)
from repro_torch.dist import run_with_restarts
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.launch.steps import train_step
from repro_torch.launch.train import train_loop
from repro_torch.optim import adamw, schedule

ROOT = Path(__file__).resolve().parents[1]
# float32 compute on both sides: the same arithmetic in another order (the
# reference's XLA chunked scans against the port's serial plain versions),
# ~1e-5 of each leaf's largest gradient at the smoke size
TOL = 1e-4
B, T = 2, 16
# the recurrent families, and the other decoder configs' loss and gradients
VARIANTS = ["rwkv6-1.6b", "jamba-v0.1-52b", "jamba-no-experts",
            "phi4-mini-3.8b", "phi3-mini-3.8b", "nemotron-4-340b",
            "phi3.5-moe-42b-a6.6b"]


def cfgs(variant: str):
    """(port, reference) smoke configs in float32 compute; Jamba without
    experts is the chip's training cut (every channel the dense SwiGLU)."""
    arch = "jamba-v0.1-52b" if variant.startswith("jamba") else variant
    port = dataclasses.replace(configs.get(arch).smoke(),
                               compute_dtype="float32")
    ref = dataclasses.replace(ref_configs.get(arch).smoke(),
                              compute_dtype="float32")
    if variant == "jamba-no-experts":
        port = dataclasses.replace(port, moe=None)
        ref = dataclasses.replace(ref, moe=None)
    return port, ref


_PARAMS: dict = {}


def ref_params(variant: str):
    if variant not in _PARAMS:
        _PARAMS[variant] = RefLM(cfgs(variant)[1]).init(jax.random.PRNGKey(0))
    return _PARAMS[variant]


def np_batch(seed: int, b: int = B, t: int = T, vocab: int = 512) -> dict:
    toks = np.random.default_rng(seed).integers(0, vocab, (b, t + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want,
                               atol=tol * max(np.abs(want).max(), 1e-3),
                               rtol=tol, err_msg=what)


# -- LM.loss and its gradients -----------------------------------------------------

@pytest.mark.parametrize("variant", VARIANTS)
def test_loss_and_every_gradient_match_reference(variant):
    cfg, rcfg = cfgs(variant)
    params = ref_params(variant)
    batch = np_batch(1)
    (want, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RefLM(rcfg).loss(p, b), has_aux=True))(
            params, to_jax(batch))
    model = lm_from_jax_params(jax.tree.map(np.asarray, params), cfg, "cpu")
    loss, parts = model.loss(to_torch(batch), remat=True)
    loss.backward()
    close(loss, want, TOL, "loss")
    close(parts["aux"], aux["aux"], TOL, "aux")
    grads = jax.tree.map(np.asarray, grads)
    for name, p in model.named_parameters():
        close(p.grad, _reference_leaf(grads, name, cfg), TOL, name)


def test_the_training_path_goes_through_both_scan_functions(monkeypatch):
    """Every recurrent layer's scan is recorded through its autograd
    Function, and each backward call reaches the backward wrapper once."""
    calls = {"scan": 0, "wkv": 0}
    real_scan, real_wkv = ms_ops.selective_scan_bwd, wkv_ops.wkv6_bwd

    def scan_bwd(*args, **kw):
        calls["scan"] += 1
        return real_scan(*args, **kw)

    def wkv_bwd(*args, **kw):
        calls["wkv"] += 1
        return real_wkv(*args, **kw)

    monkeypatch.setattr(ms_ops, "selective_scan_bwd", scan_bwd)
    monkeypatch.setattr(wkv_ops, "wkv6_bwd", wkv_bwd)
    for variant in ("rwkv6-1.6b", "jamba-no-experts"):
        cfg, _ = cfgs(variant)
        model = lm_from_jax_params(jax.tree.map(np.asarray,
                                                ref_params(variant)),
                                   cfg, "cpu")
        loss, _ = model.loss(to_torch(np_batch(2)), remat=True)
        loss.backward()
    assert calls == {"scan": cfgs("jamba-no-experts")[0].layer_kinds.count(
        "mamba"), "wkv": cfgs("rwkv6-1.6b")[0].n_layers}


# -- the optimizer's view of the recurrent and nested leaves ---------------------------

def _stacked_ndim(params, name: str, cfg) -> int:
    """ndim of the reference's leaf for the port's parameter ``name``, with
    the leading scan-group axis every layer leaf carries there."""
    parts = name.split(".")
    node = params
    if parts[0] == "layers":
        slot = int(parts[1]) % len(cfg.group_pattern)
        node, parts = params["layers"][f"slot{slot}"], parts[2:]
    for key in parts:
        node = node[key]
    return np.asarray(node).ndim


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b"])
def test_decay_mask_is_the_references_rule_on_every_leaf(arch):
    """``LM.decay_mask`` decays exactly the leaves the reference's
    ``ndim >= 2`` rule decays in its stacked tree: the recurrences' A_log,
    D, u and decay_base, and the MoE shared expert's nested leaves too."""
    cfg = configs.get(arch).smoke()
    params = jax.tree.map(np.asarray, RefLM(ref_configs.get(arch).smoke())
                          .init(jax.random.PRNGKey(0)))
    model = lm_from_jax_params(params, cfg, "cpu")
    mask = model.decay_mask()
    leaves = {name.rsplit(".", 1)[-1] for name in mask}
    want = {"rwkv6-1.6b": {"u", "decay_base", "mu"},
            "jamba-v0.1-52b": {"A_log", "D", "dt_bias"},
            "qwen2-moe-a2.7b": {"router"}}[arch]
    assert want <= leaves
    if arch == "qwen2-moe-a2.7b":
        assert any(".shared." in name for name in mask)
    for name in mask:
        assert mask[name] == (_stacked_ndim(params, name, cfg) >= 2), name


@pytest.mark.parametrize("moments", ["float32", "int8"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "qwen2-moe-a2.7b"])
def test_train_state_carries_every_moment(arch, moments):
    """``train_state_from_jax`` keys a moment for every parameter, the
    recurrent and the nested (MoE shared expert) leaves included, equal to
    the reference's for that layer."""
    cfg = configs.get(arch).smoke()
    rcfg = ref_configs.get(arch).smoke()
    params = RefLM(rcfg).init(jax.random.PRNGKey(0))
    ocfg = ref_adamw.AdamWConfig(moments_dtype=moments)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32),
                         params)
    params, opt = jax.jit(lambda p, g, s: ref_adamw.apply_updates(
        p, g, s, ocfg))(params, grads, ref_adamw.init_opt_state(params, ocfg))
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                      "step": 1})
    model, port_opt = train_state_from_jax(state, cfg, "cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sorted(port_opt["m"]) == sorted(port_opt["v"]) == sorted(names)
    assert int(port_opt["count"]) == 1
    for name in names:
        for part in ("m", "v"):
            got = port_opt[part][name]
            want = _reference_leaf(state["opt"][part], name, cfg)
            if moments == "int8":
                assert set(got) == set(want), (name, part)
                for key in got:
                    np.testing.assert_array_equal(got[key].numpy(),
                                                  want[key])
            else:
                np.testing.assert_array_equal(got.numpy(), want)


# -- train_step against the reference's steps -----------------------------------------

def _ref_steps(rcfg, params, moments, batches):
    ocfg = ref_adamw.AdamWConfig(
        learning_rate=ref_schedule.warmup_cosine(3e-4, 2, 3),
        moments_dtype=moments)
    model = RefLM(rcfg)
    grad = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    update = jax.jit(lambda p, g, s: ref_adamw.apply_updates(p, g, s, ocfg))
    opt = ref_adamw.init_opt_state(params, ocfg)
    losses, grads = [], []
    for batch in batches:
        loss, g = grad(params, to_jax(batch))
        params, opt = update(params, g, opt)
        losses.append(float(loss))
        grads.append(g)
    lr = sum(float(ocfg.lr_at(jnp.int32(i + 1))) for i in range(len(batches)))
    return jax.tree.map(np.asarray, (params, opt, grads)), losses, lr


@pytest.mark.parametrize("variant, moments", [("rwkv6-1.6b", "float32"),
                                              ("rwkv6-1.6b", "int8"),
                                              ("jamba-no-experts", "float32")])
def test_three_train_steps_match_reference(variant, moments):
    """Three AdamW steps (warmup 2, decay over 3) from the reference's
    weights and fresh moments, with weight decay on the leaves the
    reference decays.

    The losses agree within 1e-5 and the moments, which are sums of the
    gradients and their squares, within the gradients' 1e-4 of each leaf's
    largest entry (the second moment, a square, within twice that; int8
    moments, dequantized: within a code, 1e-2 of the leaf's largest entry
    and 10 % of a second moment; a code on a rounding boundary rounds
    either way, and a block whose entries are all alike has a log scale of
    1e-9, where float32 rounding moves every code).  A parameter moves by
    the sum over steps of ``lr * m / (sqrt(v) + eps)``, which divides each
    entry's gradient by its own size: an entry whose gradient is near 0
    carries the gradients' agreement (1e-4 of the leaf's largest entry) as
    a large relative error, or a flipped sign, into its step, and the next
    step's gradients follow the moved weights.  So each leaf's update, the
    three steps together, is held within 1e-2 of its L2 norm, and every
    entry within the summed learning rates (Adam's largest move)."""
    cfg, rcfg = cfgs(variant)
    params = ref_params(variant)
    batches = [np_batch(10 + i) for i in range(3)]
    (want_params, want_opt, grads), want_losses, lr = _ref_steps(
        rcfg, params, moments, batches)
    ocfg = adamw.AdamWConfig(
        learning_rate=schedule.warmup_cosine(3e-4, 2, 3),
        moments_dtype=moments)
    opt = ref_adamw.init_opt_state(
        params, ref_adamw.AdamWConfig(moments_dtype=moments))
    model, port_opt = train_state_from_jax(
        jax.tree.map(np.asarray, {"params": params, "opt": opt, "step": 0}),
        cfg, "cpu")
    losses = [float(train_step(model, port_opt, to_torch(b), ocfg,
                               remat=True)["loss"]) for b in batches]
    np.testing.assert_allclose(losses, want_losses, atol=1e-5, rtol=1e-5)
    assert int(port_opt["count"]) == 3
    for name, p in model.named_parameters():
        for part in ("m", "v"):
            got = port_opt[part][name]
            want = _reference_leaf(want_opt[part], name, cfg)
            if moments == "float32":
                np.testing.assert_allclose(
                    got.numpy(), want, rtol=0,
                    atol=(1 if part == "m" else 2) * TOL * np.abs(want).max(),
                    err_msg=(name, part))
                continue
            got = adamw.dequantize_moment(got, p.shape).numpy()
            want = np.asarray(ref_adamw.dequantize_moment(
                {k: jnp.asarray(v) for k, v in want.items()}, p.shape))
            assert np.linalg.norm(got - want) \
                <= 2e-2 * np.linalg.norm(want), (name, part)
        start = _reference_leaf(jax.tree.map(np.asarray, params), name, cfg)
        want = _reference_leaf(want_params, name, cfg) - start
        got = p.detach().numpy() - start
        floor = 1e-5 * np.abs(start).max()
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want) \
            + floor, name
        gap = np.abs(got - want)
        assert gap.max() <= floor + lr, name


# -- the CLI and the restart drill ----------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_train_cli_on_the_cpu(arch):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--steps", "3", "--batch", "2", "--seq-len", "16",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stderr and "on cpu" in proc.stderr


def test_rwkv_restart_drill_is_bitwise(tmp_path_factory):
    """A failure at step 7 of 12, checkpoints every 4: resumed from step 4,
    the final parameters and the losses after it equal an uninterrupted
    run's bit for bit."""
    cfg = configs.get("rwkv6-1.6b").smoke()
    kw = dict(steps_total=12, batch=2, seq_len=16, ckpt_every=4, log_every=0,
              device="cpu")
    clean = train_loop(cfg, ckpt_dir=tmp_path_factory.mktemp("clean"), **kw)
    report = run_with_restarts(
        lambda **k: train_loop(cfg, **k),
        ckpt_dir=tmp_path_factory.mktemp("restart"), fail_at_step=7, **kw)
    assert report.attempts == 2 and report.result["resumed_from"] == 4
    a, b = report.result["state"]["params"], clean["state"]["params"]
    assert list(a) == list(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert report.result["losses"] == clean["losses"][4:]


def test_training_data_is_the_references_stream():
    """``train_loop`` on an RWKV smoke model reads the batches the
    reference's pipeline gives for the same seed (the restart drill's
    bitwise claim rests on it)."""
    cfg = configs.get("rwkv6-1.6b").smoke()
    ref = RefPipeline(RefDataConfig(vocab_size=cfg.vocab_size, seq_len=T,
                                    global_batch=B, seed=3))
    from repro_torch.data import SyntheticPipeline
    from repro_torch.launch.train import make_data_cfg
    port = SyntheticPipeline(make_data_cfg(cfg, B, T, 3))
    for step in (0, 5):
        for key, arr in ref.batch_at(step).items():
            assert port.batch_at(step)[key].tobytes() == arr.tobytes()
