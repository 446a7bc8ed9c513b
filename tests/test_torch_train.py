"""The training slice of the port on the CPU at the smoke size: Qwen2.5-3B's
reduced config with the reference's weights and optimizer state carried
across (``train_state_from_jax``), held against the JAX package's
``LM.loss`` (its XLA path), ``jax.value_and_grad`` and
``repro.optim.adamw``; the data pipeline, checkpoints, restarts and the
train CLI; and serving without autograd now that parameters are trainable.
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
from repro.models import layers as ref_layers
from repro.models.lm import chunked_xent as ref_chunked_xent
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro_torch import configs
from repro_torch.ckpt import CheckpointManager
from repro_torch.convert import (_reference_leaf, lm_from_jax_params,
                                 train_state_from_jax)
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.dist import run_with_restarts
from repro_torch.launch.steps import train_step
from repro_torch.launch.train import make_data_cfg, train_loop
from repro_torch.models import build_model
from repro_torch.models.layers import embed_tokens
from repro_torch.models.lm import chunked_xent
from repro_torch.optim import adamw, schedule

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
# the tolerances of tests/test_torch_lm.py: float32 1e-4 (the same float32
# arithmetic in another order, XLA's blockwise softmax vs the kernels'
# plain versions); bfloat16 2e-2 (the XLA path rounds q * scale and the
# softmax weights to bf16, the kernels keep float32)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
B, T = 4, 16


def cfgs(compute_dtype: str):
    port = dataclasses.replace(configs.get(ARCH).smoke(),
                               compute_dtype=compute_dtype)
    ref = dataclasses.replace(ref_configs.get(ARCH).smoke(),
                              compute_dtype=compute_dtype)
    return port, ref


@pytest.fixture(scope="module")
def ref_params():
    _, ref = cfgs("float32")
    return RefLM(ref).init(jax.random.PRNGKey(0))


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

@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_reference(ref_params, compute_dtype):
    cfg, rcfg = cfgs(compute_dtype)
    batch = np_batch(1)
    (want, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RefLM(rcfg).loss(p, b), has_aux=True))(
            ref_params, to_jax(batch))
    model = lm_from_jax_params(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    loss, parts = model.loss(to_torch(batch))
    loss.backward()
    tol = TOL[compute_dtype]
    close(loss, want, tol, "loss")
    assert float(parts["aux"]) == float(aux["aux"]) == 0.0
    grads = jax.tree.map(np.asarray, grads)
    for name, p in model.named_parameters():
        close(p.grad, _reference_leaf(grads, name, cfg), tol, name)


def test_remat_gives_the_same_numbers():
    """Full remat and ``save_dots`` (the layer cut into checkpointed
    segments at the reference's named tensors) give the loss and the
    gradients of no remat."""
    cfg, _ = cfgs("float32")
    model = build_model(cfg, seed=3, device="cpu")
    batch = to_torch(np_batch(2))
    out = []
    for remat in (False, True, "full", "save_dots"):
        model.zero_grad(set_to_none=True)
        loss, _ = model.loss(batch, remat=remat)
        loss.backward()
        out.append((loss.detach(), [p.grad.clone()
                                    for p in model.parameters()]))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        for g, w in zip(grads, out[0][1]):
            torch.testing.assert_close(g, w, atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="remat"):
        model.loss(batch, remat="save_everything")


def test_save_dots_gradients_match_the_references(ref_params):
    """``remat="save_dots"`` against the reference's own ``save_dots``
    policy (``jax.checkpoint`` with ``save_only_these_names``), at the
    tolerance of the no-remat comparison."""
    cfg, rcfg = cfgs("float32")
    batch = np_batch(5)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RefLM(rcfg).loss(p, b, remat="save_dots"),
        has_aux=True))(ref_params, to_jax(batch))
    model = lm_from_jax_params(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    loss, _ = model.loss(to_torch(batch), remat="save_dots")
    loss.backward()
    close(loss, want, TOL["float32"], "loss")
    grads = jax.tree.map(np.asarray, grads)
    for name, p in model.named_parameters():
        close(p.grad, _reference_leaf(grads, name, cfg), TOL["float32"],
              name)


def saved_bytes(model, batch, remat) -> int:
    """The bytes autograd keeps for the backward of one loss."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(batch, remat=remat)
    loss.backward()
    model.zero_grad(set_to_none=True)
    return total[0]


def test_save_dots_keeps_more_than_full_remat_and_less_than_none():
    cfg, _ = cfgs("float32")
    model = build_model(cfg, seed=3, device="cpu")
    batch = to_torch(np_batch(2))
    full, dots, none = (saved_bytes(model, batch, r)
                        for r in (True, "save_dots", False))
    assert full < dots < none, (full, dots, none)


def test_embedding_gathers_then_casts_with_the_references_gradient():
    """The port gathers rows then casts, the reference casts then takes;
    with repeated tokens both give the same table gradient (float32)."""
    cfg, rcfg = cfgs("float32")
    rng = np.random.default_rng(4)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    tokens = rng.integers(0, 8, (3, 20))             # rows used many times
    cot = rng.standard_normal((3, 20, 8)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: ref_layers.embed_tokens(
        {"tokens": t}, jnp.asarray(tokens), rcfg), jnp.asarray(table))
    (want,) = vjp(jnp.asarray(cot))
    t = torch.from_numpy(table).requires_grad_()
    embed_tokens({"tokens": t}, torch.as_tensor(tokens), cfg).backward(
        torch.from_numpy(cot))
    close(t.grad, want, 1e-6)


def test_chunked_xent_with_a_mask_and_a_chunk_that_does_not_divide_t():
    cfg, rcfg = cfgs("float32")
    cfg = dataclasses.replace(cfg, logit_chunk=16)      # T = 50: chunk 10
    rcfg = dataclasses.replace(rcfg, logit_chunk=16)
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, 50, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32)
    targets = rng.integers(0, 40, (2, 50)).astype(np.int32)
    mask = (rng.random((2, 50)) > 0.3).astype(np.float32)
    want, vjp = jax.vjp(lambda h, w: ref_chunked_xent(
        h, w, jnp.asarray(targets), jnp.asarray(mask), rcfg),
        jnp.asarray(h), jnp.asarray(w))
    dh_want, dw_want = vjp(jnp.float32(1.0))
    ht, wt = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    got = chunked_xent(ht, wt, torch.as_tensor(targets),
                       torch.as_tensor(mask), cfg)
    got.backward()
    close(got, want, 1e-5, "loss")
    close(ht.grad, dh_want, 1e-5, "dh")
    close(wt.grad, dw_want, 1e-5, "dw")


# -- the optimizer --------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 300), (513,), (2, 4, 256), ()])
@pytest.mark.parametrize("log", [False, True])
def test_quantize_moment_matches_reference(shape, log):
    rng = np.random.default_rng(6)
    x = np.array(rng.standard_normal(shape) * 1e-3, np.float32)
    if log:
        x = np.array(np.abs(x) ** 2, np.float32)
        x.reshape(-1)[::7] = 0.0                # exact zeros: the floor
    want = ref_adamw.quantize_moment(jnp.asarray(x), log=log)
    got = adamw.quantize_moment(torch.from_numpy(x), log=log)
    assert set(got) == set(want)
    codes = got["q"].numpy().astype(int) - np.asarray(want["q"]).astype(int)
    assert got["q"].dtype == torch.int8 and codes.shape == want["q"].shape
    assert np.abs(codes).max() <= 1 and (codes != 0).mean() <= 1e-3
    for key in set(got) - {"q"}:
        close(got[key], want[key], 1e-6, key)
    back = adamw.dequantize_moment(got, shape)
    want_back = ref_adamw.dequantize_moment(want, shape)
    assert tuple(back.shape) == shape
    close(back, want_back, 1e-2 if log else 1e-6)


def test_schedules_match_reference():
    steps = np.arange(0, 40)
    for peak, port, ref in (
            (3e-4, schedule.warmup_cosine(3e-4, 20, 35),
             ref_schedule.warmup_cosine(3e-4, 20, 35)),
            (1e-3, schedule.warmup_cosine(1e-3, 0, 10, final_frac=0.0),
             ref_schedule.warmup_cosine(1e-3, 0, 10, 0.0)),
            (2e-4, schedule.constant(2e-4), ref_schedule.constant(2e-4))):
        got = np.array([float(port(int(s))) for s in steps], np.float32)
        want = np.array([float(ref(jnp.int32(s))) for s in steps], np.float32)
        # float32 on both sides, the same operations; cos from two libms
        # may differ in its last bit, which 1 + cos near -1 magnifies: at
        # most one float32 rounding of the peak rate
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=np.finfo(np.float32).eps * peak)
        assert (got == want).mean() >= 0.9


def random_grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.05), params)


@pytest.mark.parametrize("moments", ["float32", "int8"])
def test_apply_updates_matches_reference(ref_params, moments):
    """The reference takes two steps, its state is carried across, and
    both packages take a third with the same gradients."""
    cfg, _ = cfgs("float32")
    ref_cfg = ref_adamw.AdamWConfig(
        learning_rate=ref_schedule.warmup_cosine(1e-3, 2, 10),
        moments_dtype=moments)
    update = jax.jit(lambda p, g, s: ref_adamw.apply_updates(p, g, s,
                                                             ref_cfg))
    params, opt = ref_params, ref_adamw.init_opt_state(ref_params, ref_cfg)
    for seed in (0, 1):
        params, opt = update(params, random_grads(params, seed), opt)
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                      "step": 2})
    model, port_opt = train_state_from_jax(state, cfg, "cpu")
    grads = random_grads(params, 2)
    params, opt = update(params, grads, opt)
    grads, params, opt = jax.tree.map(np.asarray, (grads, params, opt))

    port_cfg = adamw.AdamWConfig(
        learning_rate=schedule.warmup_cosine(1e-3, 2, 10),
        moments_dtype=moments)
    named = dict(model.named_parameters())
    gnorm = adamw.apply_updates(
        named, {n: torch.from_numpy(np.array(_reference_leaf(grads, n, cfg)))
                for n in named}, port_opt, port_cfg,
        decay_mask=model.decay_mask())
    close(gnorm, ref_adamw.global_norm(grads), 1e-6, "gnorm")
    assert int(port_opt["count"]) == int(opt["count"]) == 3
    for name, p in named.items():
        close(p, _reference_leaf(params, name, cfg), 1e-5, name)
        for part in ("m", "v"):
            got = port_opt[part][name]
            want = _reference_leaf(opt[part], name, cfg)
            if moments == "float32":
                np.testing.assert_allclose(got.numpy(), want, atol=1e-6,
                                           rtol=1e-6, err_msg=name)
                continue
            codes = got["q"].numpy().astype(int) - want["q"].astype(int)
            assert np.abs(codes).max() <= 1, (name, part)
            assert (codes != 0).mean() <= 1e-3, (name, part)


@pytest.fixture(scope="module")
def ref_step():
    """One reference training step (float32 compute): value_and_grad of
    LM.loss averaged over ``n`` microbatches, then apply_updates."""
    _, rcfg = cfgs("float32")
    model = RefLM(rcfg)
    ocfg = ref_adamw.AdamWConfig(
        learning_rate=ref_schedule.warmup_cosine(3e-4, 20, 3))
    grad = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    update = jax.jit(lambda p, g, s: ref_adamw.apply_updates(p, g, s, ocfg))

    def step(params, opt, batch, n=1):
        rows = B // n
        losses, gsum = [], None
        for i in range(n):
            loss, g = grad(params, to_jax(
                {k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}))
            losses.append(loss)
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        grads = jax.tree.map(lambda g: g / n, gsum)
        params, opt = update(params, grads, opt)
        return (params, opt, sum(losses) / n, ref_adamw.global_norm(grads),
                grads)

    return ocfg, step


def check_state(model, opt, cfg, ref_params, ref_opt, ref_grads, lr, eps):
    """Every parameter within 1e-5 of the reference after ``len(ref_grads)``
    steps whose learning rates sum to ``lr``.

    The key bias's gradient nearly cancels (a shift shared by every key of
    a query would cancel in the softmax; RoPE rotates it by each key's
    position and leaves a remainder), so many of its entries fall to
    Adam's ``eps``, where the step ``lr * g / (|g| + eps)`` turns a
    gradient's float32 rounding ``dg`` into a change of up to
    ``lr * dg / eps``.  The key biases' moments are held at 1e-5 of each
    leaf's largest entry, every entry; their parameters at 1e-5 where every
    step's gradient is clear of ``eps`` (>= 100 eps), and elsewhere within
    ``lr * dg / eps``, ``dg`` being 1e-6 of the leaf's largest gradient.
    """
    ref_params, ref_opt, ref_grads = jax.tree.map(
        np.asarray, (ref_params, ref_opt, ref_grads))
    for name, p in model.named_parameters():
        want = _reference_leaf(ref_params, name, cfg)
        if not name.endswith("mixer.bk"):
            close(p, want, 1e-5, name)
            continue
        for part in ("m", "v"):
            ref_moment = _reference_leaf(ref_opt[part], name, cfg)
            np.testing.assert_allclose(
                opt[part][name].numpy(), ref_moment, rtol=1e-5,
                atol=1e-5 * np.abs(ref_moment).max(), err_msg=(name, part))
        g = np.abs([_reference_leaf(gr, name, cfg) for gr in ref_grads])
        clear = g.min(0) >= 100 * eps
        assert clear.mean() >= 0.25, name
        got = p.detach().numpy()
        close(got[clear], want[clear], 1e-5, name)
        rounding = lr * 1e-6 * g.max() / eps
        assert np.abs(got - want)[~clear].max(initial=0) <= rounding, name


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(ref_params, ref_step, microbatches):
    cfg, _ = cfgs("float32")
    ocfg, step = ref_step
    opt = ref_adamw.init_opt_state(ref_params, ocfg)
    state = jax.tree.map(np.asarray, {"params": ref_params, "opt": opt,
                                      "step": 0})
    model, port_opt = train_state_from_jax(state, cfg, "cpu")
    batch = np_batch(7)
    params, opt, loss, gnorm, grads = step(ref_params, opt, batch,
                                           microbatches)
    metrics = train_step(model, port_opt, to_torch(batch),
                         adamw.AdamWConfig(learning_rate=schedule
                                           .warmup_cosine(3e-4, 20, 3)),
                         microbatches=microbatches)
    close(metrics["loss"], loss, 1e-5, "loss")
    close(metrics["gnorm"], gnorm, 1e-5, "gnorm")
    assert int(metrics["step"]) == 1
    assert all(p.grad is None for p in model.parameters())
    check_state(model, port_opt, cfg, params, opt, [grads], lr=3e-4 / 20,
                eps=ocfg.eps)


def test_train_loop_matches_three_reference_steps(ref_params, ref_step):
    cfg, _ = cfgs("float32")
    ocfg, step = ref_step
    model = lm_from_jax_params(jax.tree.map(np.asarray, ref_params), cfg,
                               "cpu")
    out = train_loop(cfg, steps_total=3, batch=B, seq_len=T, log_every=0,
                     model=model)
    data = RefPipeline(RefDataConfig(vocab_size=cfg.vocab_size, seq_len=T,
                                     global_batch=B))
    params, opt, losses, grads = ref_params, ref_adamw.init_opt_state(
        ref_params, ocfg), [], []
    for i in range(3):
        params, opt, loss, _, g = step(params, opt, data.batch_at(i))
        losses.append(float(loss))
        grads.append(g)
    np.testing.assert_allclose(out["losses"], losses, atol=1e-4, rtol=1e-4)
    assert out["resumed_from"] is None and len(out["step_seconds"]) == 3
    assert int(out["state"]["step"]) == 3
    check_state(model, out["state"]["opt"], cfg, params, opt, grads,
                lr=3 * 3e-4 / 20, eps=ocfg.eps)


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("seed, index, count", [(0, 0, 1), (3, 1, 2),
                                                (11, 3, 4)])
def test_pipeline_batches_are_byte_identical(seed, index, count):
    kw = dict(vocab_size=151936, seq_len=33, global_batch=8, seed=seed)
    port = SyntheticPipeline(DataConfig(**kw), index, count)
    ref = RefPipeline(RefDataConfig(**kw), index, count)
    for step in (0, 1, 17):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert set(got) == set(want)
        for key in got:
            assert got[key].dtype == want[key].dtype
            assert got[key].tobytes() == want[key].tobytes(), (step, key)
    cfg = configs.get(ARCH)
    assert make_data_cfg(cfg, 8, 33, seed) == DataConfig(
        **kw, frontend="tokens", d_model=2048, n_patches=cfg.n_patches,
        decoder_len=cfg.decoder_len)


# -- checkpoints -----------------------------------------------------------------

def test_checkpoint_round_trip_with_bf16_and_int8_leaves(tmp_path):
    state = {"params": {"layers.0.w": torch.randn(3, 5),
                        "embed.tokens": torch.randn(4, 2).bfloat16()},
             "opt": {"m": {"layers.0.w": {"q": torch.randint(
                 -127, 128, (3, 256), dtype=torch.int8),
                 "scale": torch.rand(3, 1)}},
                 "count": torch.tensor(7, dtype=torch.int32)},
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(tmp_path)
    mgr.save(7, state, extra={"loss": 1.5})
    mgr.wait()
    step, got, extra = mgr.restore()
    assert step == 7 and extra == {"loss": 1.5}
    flat = [("params", "layers.0.w"), ("params", "embed.tokens"),
            ("opt", "m", "layers.0.w", "q"), ("opt", "m", "layers.0.w",
                                               "scale"),
            ("opt", "count"), ("step",)]
    for path in flat:
        a, b = state, got
        for key in path:
            a, b = a[key], b[key]
        assert a.dtype == b.dtype and torch.equal(a, b), path
    arrays = sorted((tmp_path / "step_000000007").glob("arr_*.npy"))
    assert len(arrays) == 6
    assert np.load(arrays[1]).dtype == np.uint16       # bf16 as uint16


def test_checkpoint_ignores_tmp_and_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_save=False)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.all_steps() == [3, 4, 5]
    (tmp_path / "step_000000009.tmp").mkdir()          # a crash mid-save
    assert mgr.latest_step() == 5
    step, state, _ = mgr.restore()
    assert step == 5 and state["x"].tolist() == [5.0, 5.0]


def test_async_save_snapshots_before_returning(tmp_path):
    """``save`` copies the leaves before it returns, so updating them in
    place afterwards (as the optimizer does) cannot leak into the file;
    ``wait`` joins the writer."""
    mgr = CheckpointManager(tmp_path)
    x = torch.zeros(1000)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    assert mgr._worker is None and mgr.latest_step() == 1
    assert torch.count_nonzero(mgr.restore(1)[1]["x"]) == 0


# -- restarts: mirrors of tests/test_fault_tolerance.py ------------------------------

SMOKE = configs.get(ARCH).smoke()
KW = dict(steps_total=12, batch=4, seq_len=32, ckpt_every=4, log_every=0,
          device="cpu")


def test_injected_failure_then_restart_bitwise(tmp_path_factory):
    clean = train_loop(SMOKE, ckpt_dir=tmp_path_factory.mktemp("clean"),
                       **KW)
    report = run_with_restarts(
        lambda **kw: train_loop(SMOKE, **kw),
        ckpt_dir=tmp_path_factory.mktemp("restart"), fail_at_step=7, **KW)
    assert report.attempts == 2
    assert "injected failure" in report.failures[0]
    assert report.result["resumed_from"] == 4
    a, b = report.result["state"]["params"], clean["state"]["params"]
    assert list(a) == list(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert report.result["losses"] == clean["losses"][4:]


def test_restart_gives_up_after_max_attempts():
    def always_fails(**kw):
        raise RuntimeError("node down")

    with pytest.raises(RuntimeError):
        run_with_restarts(always_fails, max_restarts=2)


def test_training_reduces_loss():
    out = train_loop(SMOKE, steps_total=40, batch=8, seq_len=64,
                     log_every=0, device="cpu")
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5]) - 0.01


def test_incompatible_checkpoint_starts_fresh(tmp_path):
    CheckpointManager(tmp_path, async_save=False).save(
        4, {"params": {"w": torch.zeros(2)}, "opt": {}, "step": 4})
    out = train_loop(SMOKE, ckpt_dir=tmp_path, **{**KW, "steps_total": 2})
    assert out["resumed_from"] is None and len(out["losses"]) == 2


# -- the CLI and serving ------------------------------------------------------------

def run_train(*args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--steps", "3", "--batch", "2", "--seq-len", "16",
         *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)


def test_train_cli_on_the_cpu():
    proc = run_train("--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stderr and "on cpu" in proc.stderr


def test_train_cli_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    proc = run_train()
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_serving_records_no_graph():
    """Parameters require grad; prefill and decode run without autograd."""
    model = build_model(SMOKE, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    tokens = torch.as_tensor(np.random.default_rng(8).integers(
        0, SMOKE.vocab_size, (2, 6)))
    logits, state = model.prefill(tokens, max_len=8)
    assert not logits.requires_grad and logits.grad_fn is None
    assert not any(c.requires_grad for s in state for c in s.values())
    logits, state = model.decode_step(state, tokens[:, :1], 6)
    assert not logits.requires_grad and logits.grad_fn is None
    fresh = model.init_decode_state(2, 8)
    logits, _ = model.decode_step(fresh, tokens[:, :1], 0)
    assert not logits.requires_grad
