"""The encoder-decoder family of the port on the CPU at the smoke size:
Whisper-base's reduced config with the reference's weights carried across
(``encdec_from_jax_params``), held against the JAX package's ``EncDec``
(its XLA attention path): sinusoidal positions, the encoder, the loss and
every gradient, cross-attention prefill and decode logits, the serving
session's greedy tokens, three training steps, and the decay mask against
the reference's AdamW.
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
from repro.launch.serve import serve_session as ref_serve_session
from repro.models import EncDec as RefEncDec
from repro.models import layers as ref_layers
from repro.optim import adamw as ref_adamw
from repro.optim import schedule as ref_schedule
from repro_torch import configs
from repro_torch.convert import (_reference_leaf, encdec_from_jax_params,
                                 train_state_from_jax)
from repro_torch.launch.serve import serve_session
from repro_torch.launch.steps import train_step
from repro_torch.launch.train import train_loop
from repro_torch.models import EncDec, build_model
from repro_torch.models.attention import decode_attention
from repro_torch.models.layers import sinusoidal_positions
from repro_torch.optim import adamw, schedule

ROOT = Path(__file__).resolve().parents[1]
ARCH = "whisper-base"
# float32 compute on both sides: the same arithmetic in another order (the
# reference's blockwise online softmax against the kernels' plain
# versions), the gates of tests/test_torch_train.py
TOL = 1e-4
B, S_ENC = 2, 12          # batch, encoder frames (the decoder takes 16)


def cfgs(compute_dtype: str = "float32"):
    """(port, reference) smoke configs."""
    return (dataclasses.replace(configs.get(ARCH).smoke(),
                                compute_dtype=compute_dtype),
            dataclasses.replace(ref_configs.get(ARCH).smoke(),
                                compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def ref_params():
    _, rcfg = cfgs()
    return RefEncDec(rcfg).init(jax.random.PRNGKey(0))


def port_model(params, compute_dtype: str = "float32"):
    return encdec_from_jax_params(jax.tree.map(np.asarray, params),
                                  cfgs(compute_dtype)[0], "cpu")


def np_batch(seed: int, b: int = B, s_enc: int = S_ENC) -> dict:
    cfg, _ = cfgs()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, cfg.decoder_len + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "frame_embeds": (rng.standard_normal((b, s_enc, cfg.d_model))
                             * 0.02).astype(np.float32)}


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


@pytest.mark.parametrize("n_pos, d", [(16, 128), (1500, 512), (7, 10)])
def test_sinusoidal_positions_match_reference(n_pos, d):
    got = sinusoidal_positions(n_pos, d)
    assert got.shape == (n_pos, d) and got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_layers.sinusoidal_positions(n_pos, d)),
        atol=1e-6, rtol=1e-6)


def test_encoder_matches_reference(ref_params):
    cfg, rcfg = cfgs()
    frames = np_batch(3)["frame_embeds"]
    want = RefEncDec(rcfg).encode(ref_params, jnp.asarray(frames))
    model = port_model(ref_params)
    with torch.no_grad():
        got = model.encode(torch.as_tensor(frames))
    assert got.shape == (B, S_ENC, cfg.d_model)
    close(got, want, TOL, "encode")


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_match_reference(ref_params, remat):
    """The decoder's cross-attention reads 12 encoder states with 16
    queries: the flash-attention path at Tq != Tk, unmasked, both ways."""
    cfg, rcfg = cfgs()
    batch = np_batch(1)
    (want, aux), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RefEncDec(rcfg).loss(p, b), has_aux=True))(
            ref_params, to_jax(batch))
    model = port_model(ref_params)
    loss, parts = model.loss(to_torch(batch), remat=remat)
    loss.backward()
    close(loss, want, TOL, "loss")
    assert float(parts["aux"]) == float(aux["aux"]) == 0.0
    grads = jax.tree.map(np.asarray, grads)
    names = [n for n, _ in model.named_parameters()]
    assert any(n.startswith("decoder.0.cross.") for n in names)
    for name, p in model.named_parameters():
        close(p.grad, _reference_leaf(grads, name, cfg), TOL, name)


def test_prefill_cross_then_decode_logits_match_reference(ref_params):
    """The encoder's keys and values in every cross cache, then decode
    steps at positions 0..3 and past ``decoder_len`` (where both packages
    clamp the position embedding), float32 at 1e-4."""
    cfg, rcfg = cfgs()
    ref = RefEncDec(rcfg)
    frames = np_batch(4)["frame_embeds"]
    model = port_model(ref_params).cast_for_serving()
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, 6))
    positions = [0, 1, 2, 3, cfg.decoder_len + 1, cfg.decoder_len + 2]
    max_len = cfg.decoder_len + 4
    state = ref.init_decode_state(B, max_len, cross_len=S_ENC)
    state = jax.jit(ref.prefill_cross)(ref_params, state, jnp.asarray(frames))
    cache = model.init_decode_state(B, max_len, cross_len=S_ENC)
    cache = model.prefill_cross(cache, torch.as_tensor(frames))
    for i, layer in enumerate(cache):
        close(layer["cross"]["k"], state["cross"]["k"][i], TOL, f"k {i}")
        close(layer["cross"]["v"], state["cross"]["v"][i], TOL, f"v {i}")
    decode = jax.jit(ref.decode_step)
    for i, pos in enumerate(positions):
        tok = tokens[:, i:i + 1]
        want, state = decode(ref_params, state, jnp.asarray(tok, jnp.int32),
                             jnp.int32(pos))
        got, cache = model.decode_step(cache, torch.as_tensor(tok), pos)
        assert got.shape == (B, 1, cfg.vocab_size)
        assert got.dtype == torch.float32
        close(got, want, TOL, f"decode at {pos}")


def test_cross_decode_attention_leaves_its_cache_untouched(ref_params):
    cfg, _ = cfgs()
    model = port_model(ref_params)
    p = model.decoder[0]["cross"]
    gen = torch.Generator().manual_seed(0)
    cache = {n: torch.randn((B, S_ENC, cfg.n_kv_heads, cfg.head_dim),
                            generator=gen) for n in ("k", "v")}
    before = {n: t.clone() for n, t in cache.items()}
    x = torch.randn((B, 1, cfg.d_model), generator=gen)
    with torch.no_grad():
        out, after = decode_attention(p, x, cache, cfg, pos=3, cross=True)
        # the same as attending over every position, whatever ``pos``
        again, _ = decode_attention(p, x, cache, cfg, pos=0, cross=True)
    assert out.shape == (B, 1, cfg.d_model)
    for n in ("k", "v"):
        assert torch.equal(after[n], before[n]) and after[n] is cache[n]
    torch.testing.assert_close(out, again, atol=0, rtol=0)


def test_cross_blocks_have_no_qkv_bias():
    cfg = dataclasses.replace(configs.get(ARCH).smoke(), qkv_bias=True)
    model = build_model(cfg, device="meta")
    layer = model.decoder[0]
    assert "bq" in layer["self"] and "bq" not in layer["cross"]
    assert "bk" in model.encoder[0]["mixer"]


def test_serve_session_tokens_equal_the_references():
    """The reference's ``serve_session`` (weights from ``PRNGKey(seed)``,
    frames drawn after the prompt tokens from ``default_rng(seed)``) and
    the port's with those weights, float32: the same greedy tokens,
    decoding past ``decoder_len``."""
    cfg, rcfg = cfgs()
    seed, batch, prompt_len, gen = 2, 2, 10, cfg.decoder_len + 4
    want = ref_serve_session(rcfg, batch=batch, prompt_len=prompt_len,
                             gen=gen, seed=seed)["generated"]
    model = port_model(RefEncDec(rcfg).init(jax.random.PRNGKey(seed)))
    out = serve_session(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                        seed=seed, model=model.cast_for_serving())
    assert out["generated"].shape == (batch, gen)
    assert (out["generated"][:, 0] == 0).all()
    np.testing.assert_array_equal(out["generated"], want)
    assert out["prefill_s"] > 0 and out["tokens_per_s"] > 0


def _stacked_ndim(params, name: str) -> int:
    """The ndim of ``name``'s leaf in the reference's stacked tree."""
    parts = name.split(".")
    node = params
    if parts[0] in ("encoder", "decoder"):
        node, parts = params[parts[0]], parts[2:]
    for key in parts:
        node = node[key]
    return np.asarray(node).ndim


def test_decay_mask_is_the_references_rule_and_adamw_agrees(ref_params):
    """``EncDec.decay_mask`` decays the leaves the reference's ``ndim >= 2``
    rule decays in its stacked tree (every layer's norms, not ``enc_norm``
    or ``final_norm``), and one AdamW step with weight decay gives the
    reference's parameters."""
    cfg, _ = cfgs()
    params = jax.tree.map(np.asarray, ref_params)
    model = port_model(ref_params)
    mask = model.decay_mask()
    for name in mask:
        assert mask[name] == (_stacked_ndim(params, name) >= 2), name
    assert mask["decoder.0.norm_x.scale"] and mask["encoder.1.norm2.bias"]
    assert not mask["enc_norm.scale"] and not mask["final_norm.bias"]

    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
    rcfg = ref_adamw.AdamWConfig(learning_rate=1e-2, weight_decay=0.5)
    want, _ = jax.jit(lambda p, g, s: ref_adamw.apply_updates(p, g, s, rcfg))(
        ref_params, grads, ref_adamw.init_opt_state(ref_params, rcfg))
    pcfg = adamw.AdamWConfig(learning_rate=1e-2, weight_decay=0.5)
    named = dict(model.named_parameters())
    with torch.no_grad():
        adamw.apply_updates(
            named, {n: torch.from_numpy(np.array(_reference_leaf(grads, n,
                                                                 cfg)))
                    for n in named},
            adamw.init_opt_state(named, pcfg), pcfg, decay_mask=mask)
    want = jax.tree.map(np.asarray, want)
    for name, p in named.items():
        close(p, _reference_leaf(want, name, cfg), 1e-5, name)


def test_train_state_carries_every_moment(ref_params):
    cfg, _ = cfgs()
    ocfg = ref_adamw.AdamWConfig()
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32),
                         ref_params)
    params, opt = jax.jit(lambda p, g, s: ref_adamw.apply_updates(
        p, g, s, ocfg))(ref_params, grads,
                        ref_adamw.init_opt_state(ref_params, ocfg))
    state = jax.tree.map(np.asarray, {"params": params, "opt": opt,
                                      "step": 1})
    model, opt_state = train_state_from_jax(state, cfg, "cpu")
    assert isinstance(model, EncDec)
    names = [n for n, _ in model.named_parameters()]
    assert sorted(opt_state["m"]) == sorted(names)
    for name in names:
        for part in ("m", "v"):
            np.testing.assert_array_equal(
                opt_state[part][name].numpy(),
                _reference_leaf(state["opt"][part], name, cfg))


def _ref_step(rcfg, ocfg):
    model = RefEncDec(rcfg)
    grad = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b)[0]))
    update = jax.jit(lambda p, g, s: ref_adamw.apply_updates(p, g, s, ocfg))

    def step(params, opt, batch):
        loss, g = grad(params, to_jax(batch))
        params, opt = update(params, g, opt)
        return params, opt, float(loss), g

    return step


def check_moves(model, cfg, start, params, lr):
    """Each parameter's move from ``start`` against the reference's: within
    1e-2 of its L2 norm, and every entry within the summed learning rates
    ``lr`` (Adam's largest move).  Adam divides each entry's gradient by
    its own size, so an entry whose gradient is near 0 (a LayerNorm bias
    starts at 0) turns the gradients' float32 agreement into a visible
    gap in its step; tests/test_torch_train_ssm.py holds moves the same
    way."""
    start, params = jax.tree.map(np.asarray, (start, params))
    for name, p in model.named_parameters():
        s = _reference_leaf(start, name, cfg)
        want = _reference_leaf(params, name, cfg) - s
        got = p.detach().numpy() - s
        floor = 1e-5 * np.abs(s).max()
        assert np.linalg.norm(got - want) <= 1e-2 * np.linalg.norm(want) \
            + floor, name
        assert np.abs(got - want).max() <= floor + lr, name


def test_train_step_matches_reference(ref_params):
    """One step under remat: the loss within 1e-5, both moments within
    1e-4 of each leaf's largest entry (they are the gradients and their
    squares), the moves as ``check_moves`` holds them."""
    cfg, rcfg = cfgs()
    ocfg = ref_adamw.AdamWConfig(
        learning_rate=ref_schedule.warmup_cosine(3e-4, 20, 3))
    opt = ref_adamw.init_opt_state(ref_params, ocfg)
    model, port_opt = train_state_from_jax(
        jax.tree.map(np.asarray, {"params": ref_params, "opt": opt,
                                  "step": 0}), cfg, "cpu")
    batch = np_batch(7)
    params, opt, loss, _ = _ref_step(rcfg, ocfg)(ref_params, opt, batch)
    metrics = train_step(model, port_opt, to_torch(batch),
                         adamw.AdamWConfig(learning_rate=schedule
                                           .warmup_cosine(3e-4, 20, 3)),
                         remat=True)
    close(metrics["loss"], loss, 1e-5, "loss")
    assert int(metrics["step"]) == 1
    opt = jax.tree.map(np.asarray, opt)
    for name, _ in model.named_parameters():
        for part in ("m", "v"):
            want = _reference_leaf(opt[part], name, cfg)
            np.testing.assert_allclose(
                port_opt[part][name].numpy(), want, rtol=0,
                atol=(1 if part == "m" else 2) * TOL * np.abs(want).max(),
                err_msg=(name, part))
    check_moves(model, cfg, ref_params, params, lr=3e-4 / 20)


def test_train_loop_matches_three_reference_steps(ref_params):
    """``train_loop`` on the reference's data stream (frame embeddings of
    ``seq_len`` frames, ``decoder_len`` tokens) against three reference
    steps: losses within 1e-4, the moves as ``check_moves`` holds them."""
    cfg, rcfg = cfgs()
    ocfg = ref_adamw.AdamWConfig(
        learning_rate=ref_schedule.warmup_cosine(3e-4, 20, 3))
    model = port_model(ref_params)
    out = train_loop(cfg, steps_total=3, batch=B, seq_len=S_ENC,
                     log_every=0, model=model)
    data = RefPipeline(RefDataConfig(
        vocab_size=cfg.vocab_size, seq_len=S_ENC, global_batch=B,
        frontend=cfg.frontend, d_model=cfg.d_model,
        n_patches=cfg.n_patches, decoder_len=cfg.decoder_len))
    step = _ref_step(rcfg, ocfg)
    params, opt, losses = ref_params, ref_adamw.init_opt_state(
        ref_params, ocfg), []
    for i in range(3):
        batch = data.batch_at(i)
        assert batch["frame_embeds"].shape == (B, S_ENC, cfg.d_model)
        params, opt, loss, _ = step(params, opt, batch)
        losses.append(loss)
    np.testing.assert_allclose(out["losses"], losses, atol=1e-4, rtol=1e-4)
    assert int(out["state"]["step"]) == 3
    lr = sum(float(ocfg.lr_at(jnp.int32(i + 1))) for i in range(3))
    check_moves(model, cfg, ref_params, params, lr)


def _cli(module: str, *args: str) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run(
        [sys.executable, "-m", module, "--arch", ARCH, "--smoke",
         "--device", "cpu", *args], capture_output=True, text=True,
        env=env, timeout=300)


def test_serve_and_train_clis_on_the_cpu():
    proc = _cli("repro_torch.launch.serve", "--batch", "2", "--prompt-len",
                "8", "--gen", "4")
    assert proc.returncode == 0, proc.stderr
    assert "sample tokens" in proc.stderr
    proc = _cli("repro_torch.launch.train", "--steps", "2", "--batch", "2",
                "--seq-len", "8")
    assert proc.returncode == 0, proc.stderr
    assert "final loss" in proc.stderr


def test_stream_and_request_serving_stay_decoder_only():
    from repro_torch.launch.serve import serve_requests, serve_stream

    cfg, _ = cfgs()
    with pytest.raises(ValueError, match="decoder-only"):
        serve_stream(cfg, groups=[], batch=2, prompt_len=4, gen=2)
    with pytest.raises(ValueError, match="decoder-only"):
        serve_requests(cfg, groups=[], n_requests=1, rate_rps=1.0,
                       prompt_len=4, gen=2)
