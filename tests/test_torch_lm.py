"""The LM-serving slice of the port as a whole, on the CPU at the smoke size:
Qwen2.5-3B's reduced config, the reference's weights carried across with
``lm_from_jax_params``, prefill and decode logits and greedy tokens held
against the JAX package's ``LM`` (whose ``attn_impl="auto"`` is its XLA
path; its Pallas path does not run here).
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
from repro.models import LM as RefLM
from repro.models import build_model as ref_build_model
from repro_torch import configs
from repro_torch.convert import lm_from_jax_params
from repro_torch.launch.serve import serve_session
from repro_torch.models import EncDec, build_model, missing_layer
from repro_torch.models.attention import full_attention

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen2.5-3b"
# float32: both packages do the same float32 arithmetic in another order
# (XLA's blockwise online softmax vs the plain scores); 1e-4 on logits of
# O(0.1).  bfloat16: 2e-2 — the XLA path rounds q * scale and the softmax
# weights to bf16 where the kernels keep float32.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def smoke_cfg(compute_dtype: str):
    return dataclasses.replace(configs.get(ARCH).smoke(),
                               compute_dtype=compute_dtype)


@pytest.fixture(scope="module")
def ref_params():
    cfg = ref_configs.get(ARCH).smoke()
    return jax.tree.map(np.asarray, RefLM(cfg).init(jax.random.PRNGKey(0)))


def ref_model(compute_dtype: str):
    return RefLM(dataclasses.replace(ref_configs.get(ARCH).smoke(),
                                     compute_dtype=compute_dtype))


def test_configs_are_copies_of_the_references():
    for name in configs.ARCH_NAMES:
        assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(
            ref_configs.get(name))
        assert dataclasses.asdict(configs.get(name).smoke()) == \
            dataclasses.asdict(ref_configs.get(name).smoke())
        assert configs.get(name).param_count() == \
            ref_configs.get(name).param_count()
    assert configs.ARCH_NAMES == ref_configs.ARCH_NAMES


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_logits_match_reference(ref_params, compute_dtype):
    cfg = smoke_cfg(compute_dtype)
    model = lm_from_jax_params(ref_params, cfg, "cpu").cast_for_serving()
    ref = ref_model(compute_dtype)
    b, t, n_decode = 2, 12, 4
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (b, t + n_decode))
    want, state = jax.jit(lambda p, x: ref.prefill(p, x, max_len=t + 8))(
        ref_params, jnp.asarray(tokens[:, :t], jnp.int32))
    got, cache = model.prefill(torch.as_tensor(tokens[:, :t]), max_len=t + 8)
    tol = TOL[compute_dtype]
    assert got.shape == (b, 1, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)
    decode = jax.jit(ref.decode_step)
    for i in range(n_decode):
        tok = tokens[:, t + i:t + i + 1]
        want, state = decode(ref_params, state, jnp.asarray(tok, jnp.int32),
                             jnp.int32(t + i))
        got, cache = model.decode_step(cache, torch.as_tensor(tok), t + i)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=tol, err_msg=f"decode step {i}")


def test_greedy_tokens_match_a_jax_greedy_loop(ref_params):
    cfg = smoke_cfg("float32")
    model = lm_from_jax_params(ref_params, cfg, "cpu")
    batch, prompt_len, gen, seed = 2, 8, 6, 3
    out = serve_session(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                        seed=seed, model=model)

    ref = ref_model("float32")
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (batch, prompt_len))
    logits, state = ref.prefill(ref_params, jnp.asarray(prompt, jnp.int32),
                                max_len=prompt_len + gen)
    last = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [last]
    decode = jax.jit(ref.decode_step)
    for i in range(gen - 1):
        logits, state = decode(ref_params, state, last,
                               jnp.int32(prompt_len + i))
        last = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(last)
    np.testing.assert_array_equal(out["generated"],
                                  np.asarray(jnp.concatenate(want, axis=1)))
    assert out["generated"].shape == (batch, gen)
    assert out["prefill_s"] > 0 and out["tokens_per_s"] > 0


def test_prefill_then_decode_matches_prefill():
    """logits(prefill(x[:n]) -> decode x[n]) == logits(prefill(x[:n+1]))
    (float32, 1e-4), mirroring the reference's own check."""
    cfg = dataclasses.replace(smoke_cfg("float32"), param_dtype="float32")
    model = build_model(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    full, _ = model.prefill(tokens)
    _, state = model.prefill(tokens[:, :15], max_len=20)
    step, _ = model.decode_step(state, tokens[:, 15:], 15)
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-4)


def test_full_width_model_has_the_configs_parameter_count():
    cfg = configs.get(ARCH)
    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == cfg.param_count()
    assert len(model.layers) == cfg.n_layers == 36
    assert model.layers[0]["mixer"]["wk"].shape == (2048, 2, 128)


def test_cast_for_serving_keeps_the_norms_in_param_dtype():
    model = build_model(smoke_cfg("bfloat16"), device="cpu")
    model.cast_for_serving()
    for name, p in model.named_parameters():
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_every_config_builds_with_the_reference_trees_parameter_count(name):
    """Every config builds at full size on ``meta`` (``missing_layer``
    refuses none), with as many parameters as the reference's tree
    (``jax.eval_shape`` of its ``build_model(cfg).init``)."""
    cfg = configs.get(name)
    assert missing_layer(cfg) is None
    model = build_model(cfg, device="meta")
    assert isinstance(model, EncDec) == cfg.encdec
    shapes = jax.eval_shape(ref_build_model(ref_configs.get(name)).init,
                            jax.random.PRNGKey(0))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))


@pytest.mark.parametrize("field, value, named", [
    ("layer_kinds", ("attn", "hyena"), "'hyena' mixer"),
    ("frontend", "stub_video", "'stub_video' frontend"),
    ("positions", "alibi", "'alibi' positions")])
def test_an_unknown_layer_is_still_named(field, value, named):
    cfg = dataclasses.replace(configs.get(ARCH).smoke(), **{field: value})
    assert named in missing_layer(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        build_model(cfg, device="meta")


# leaves of the reference's parameter tree that ArchConfig.param_breakdown
# (a copy of the reference's) leaves out, per layer: the mamba conv bias,
# two of the rwkv time mix's ten d-vectors, the shared experts' gate
UNCOUNTED = {"rwkv6-1.6b": lambda c: 2 * c.d_model * c.n_layers,
             "jamba-v0.1-52b": lambda c: (c.mamba.expand * c.d_model
                                          * c.layer_kinds.count("mamba")),
             "qwen2-moe-a2.7b": lambda c: c.d_model * c.n_layers,
             "phi3.5-moe-42b-a6.6b": lambda c: 0}


@pytest.mark.parametrize("name", sorted(UNCOUNTED))
def test_recurrent_and_moe_families_build_at_full_size(name):
    """Built on ``meta`` at full size: the same parameters, leaf for leaf,
    as the reference's tree (``jax.eval_shape`` of its init), which is
    ``cfg.param_count()`` plus the leaves that count leaves out."""
    cfg = configs.get(name)
    model = build_model(cfg, device="meta")
    got = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(RefLM(ref_configs.get(name)).init,
                            jax.random.PRNGKey(0))
    assert got == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert got == cfg.param_count() + UNCOUNTED[name](cfg)
    assert len(model.layers) == cfg.n_layers


def test_attn_impl_xla_is_refused():
    cfg = dataclasses.replace(smoke_cfg("float32"), attn_impl="xla")
    model = build_model(dataclasses.replace(cfg, attn_impl="auto"),
                        device="cpu")
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="plain PyTorch versions"):
        full_attention(model.layers[0]["mixer"], x, cfg,
                       positions=torch.arange(4)[None])


def test_converter_rejects_a_tree_that_does_not_fit(ref_params):
    cfg = smoke_cfg("float32")
    bad = jax.tree.map(lambda a: a, ref_params)
    del bad["layers"]["slot0"]["mixer"]["bq"]
    with pytest.raises(ValueError, match="mixer"):
        lm_from_jax_params(bad, cfg, "cpu")
    wide = dataclasses.replace(cfg, d_ff=2 * cfg.d_ff)
    with pytest.raises(ValueError, match="shape"):
        lm_from_jax_params(ref_params, wide, "cpu")


def run_serve(*args):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "4", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_serve_cli_on_the_cpu():
    proc = run_serve("--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "tok/s on cpu" in proc.stderr and "sample tokens" in proc.stderr


def test_serve_cli_needs_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    proc = run_serve()
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_sampling_follows_the_seed():
    """``greedy=False`` draws each token from the softmax with a generator
    seeded from ``seed``: the same seed gives the same tokens."""
    cfg = smoke_cfg("float32")
    model = build_model(cfg, seed=0, device="cpu")
    kw = dict(batch=2, prompt_len=6, gen=5, greedy=False, model=model)
    a = serve_session(cfg, seed=4, **kw)["generated"]
    b = serve_session(cfg, seed=4, **kw)["generated"]
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 5) and ((0 <= a) & (a < cfg.vocab_size)).all()
