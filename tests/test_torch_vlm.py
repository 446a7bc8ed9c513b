"""The VLM frontend of the port on the CPU at the smoke size: InternVL2-76B's
reduced config (``frontend="stub_patches"``: precomputed patch embeddings
prepended to the text) with the reference's weights carried across by
``lm_from_jax_params``, held against the JAX package's ``LM`` (its XLA
attention path): the embedded inputs, the loss and every gradient, and a
prefill with patches followed by decode steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import LM as RefLM
from repro_torch import configs
from repro_torch.convert import _reference_leaf, lm_from_jax_params
from repro_torch.launch.serve import serve_session

ARCH = "internvl2-76b"
# float32 compute on both sides, the gates of tests/test_torch_train.py
TOL = 1e-4
B, T = 2, 12


def cfgs():
    """(port, reference) smoke configs, float32 compute."""
    return (dataclasses.replace(configs.get(ARCH).smoke(),
                                compute_dtype="float32"),
            dataclasses.replace(ref_configs.get(ARCH).smoke(),
                                compute_dtype="float32"))


@pytest.fixture(scope="module")
def ref_params():
    return RefLM(cfgs()[1]).init(jax.random.PRNGKey(0))


def port_model(params):
    return lm_from_jax_params(jax.tree.map(np.asarray, params), cfgs()[0],
                              "cpu")


def np_batch(seed: int) -> dict:
    cfg, _ = cfgs()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "loss_mask": (rng.random((B, T)) > 0.2).astype(np.float32),
            "patch_embeds": (rng.standard_normal(
                (B, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)}


def close(got, want, tol, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want,
                               atol=tol * max(np.abs(want).max(), 1e-3),
                               rtol=tol, err_msg=what)


def test_embed_inputs_prepend_the_patches_out_of_the_loss(ref_params):
    cfg, rcfg = cfgs()
    batch = np_batch(0)
    want = RefLM(rcfg).embed_inputs(
        ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = port_model(ref_params).embed_inputs(
            {k: torch.as_tensor(v) for k, v in batch.items()})
    p = cfg.n_patches
    assert got[0].shape == (B, p + T, cfg.d_model)
    for name, g, w in zip(("x", "positions", "targets", "mask"), got, want):
        assert tuple(g.shape) == w.shape, name
        close(g, w, 1e-6, name)
    assert (got[3][:, :p] == 0).all() and (got[2][:, :p] == 0).all()


def test_loss_and_every_gradient_match_reference(ref_params):
    cfg, rcfg = cfgs()
    batch = np_batch(1)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: RefLM(rcfg).loss(p, b), has_aux=True))(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    model = port_model(ref_params)
    loss, _ = model.loss({k: torch.as_tensor(v) for k, v in batch.items()},
                         remat=True)
    loss.backward()
    close(loss, want, TOL, "loss")
    grads = jax.tree.map(np.asarray, grads)
    for name, p in model.named_parameters():
        close(p.grad, _reference_leaf(grads, name, cfg), TOL, name)


def test_prefill_with_patches_then_decode_logits_match_reference(ref_params):
    """Prefill P patches and T tokens, then 4 decode steps from position
    P + T, float32 at 1e-4."""
    cfg, rcfg = cfgs()
    ref = RefLM(rcfg)
    model = port_model(ref_params).cast_for_serving()
    batch = np_batch(2)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, 4))
    s = cfg.n_patches + T
    want, state = jax.jit(lambda p, t, e: ref.prefill(
        p, t, max_len=s + 8, patch_embeds=e))(
            ref_params, jnp.asarray(batch["tokens"]),
            jnp.asarray(batch["patch_embeds"]))
    got, cache = model.prefill(torch.as_tensor(batch["tokens"]),
                               max_len=s + 8,
                               patch_embeds=torch.as_tensor(
                                   batch["patch_embeds"]))
    assert got.shape == (B, 1, cfg.vocab_size)
    assert cache[0]["k"].shape[1] == s + 8
    close(got, want, TOL, "prefill")
    decode = jax.jit(ref.decode_step)
    for i in range(4):
        tok = tokens[:, i:i + 1]
        want, state = decode(ref_params, state, jnp.asarray(tok, jnp.int32),
                             jnp.int32(s + i))
        got, cache = model.decode_step(cache, torch.as_tensor(tok), s + i)
        close(got, want, TOL, f"decode {i}")


def test_serve_session_runs_the_vlm_on_its_text(ref_params):
    """``serve_session`` serves the VLM on its text alone (the reference's
    session calls ``prefill`` without patches, where the reference's
    ``embed_inputs`` raises ``KeyError``): the same greedy tokens as the
    reference's decoder on the text, ``frontend="tokens"``."""
    cfg, rcfg = cfgs()
    seed, batch, prompt_len, gen = 1, 2, 8, 5
    out = serve_session(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                        seed=seed, model=port_model(ref_params))
    ref = RefLM(dataclasses.replace(rcfg, frontend="tokens"))
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (batch, prompt_len))
    logits, state = ref.prefill(ref_params, jnp.asarray(prompt, jnp.int32),
                                max_len=prompt_len + gen)
    last = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [last]
    for i in range(gen - 1):
        logits, state = ref.decode_step(ref_params, state, last,
                                        jnp.int32(prompt_len + i))
        last = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(last)
    np.testing.assert_array_equal(out["generated"],
                                  np.asarray(jnp.concatenate(want, axis=1)))
