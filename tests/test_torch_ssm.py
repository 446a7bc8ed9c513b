"""The recurrent-serving slice of the port on the CPU at the smoke size:
RWKV-6 and Jamba (Mamba + attention + MoE), and the MoE family, with the
reference's weights carried across by ``lm_from_jax_params``.  Modules
(group norm, the RWKV time and channel mix, the Mamba mixer and its
decode step, the MoE layer) and whole models (prefill and decode logits,
greedy tokens) are held against the JAX package (its ``attn_impl="auto"``
XLA path: its Pallas path does not run here).
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
from repro.models import blocks as ref_blocks
from repro.models import layers as ref_layers
from repro.models import mamba as ref_mamba
from repro.models import moe as ref_moe
from repro.models import rwkv6 as ref_rwkv
from repro_torch import configs
from repro_torch.convert import lm_from_jax_params
from repro_torch.launch.serve import serve_session
from repro_torch.models import build_model
from repro_torch.models import layers, mamba, moe, rwkv6
from repro_torch.models.lm import serving_dtype

ROOT = Path(__file__).resolve().parents[1]
# float32: the same float32 arithmetic in another order (1e-5 for a module,
# 1e-4 for logits through a whole model, as tests/test_torch_lm.py).
# bfloat16: 2e-2, one bf16 ulp of an O(1) value is 2^-7 ~ 8e-3 and the two
# packages round products summed in another order.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def cfgs(arch: str, compute_dtype: str = "float32"):
    """(reference, port) smoke configs of ``arch``."""
    return (dataclasses.replace(ref_configs.get(arch).smoke(),
                                compute_dtype=compute_dtype),
            dataclasses.replace(configs.get(arch).smoke(),
                                compute_dtype=compute_dtype))


_PARAMS: dict = {}


def ref_params(arch: str):
    """The reference's smoke-size weights (numpy leaves), made once."""
    if arch not in _PARAMS:
        cfg = ref_configs.get(arch).smoke()
        _PARAMS[arch] = jax.tree.map(np.asarray,
                                     RefLM(cfg).init(jax.random.PRNGKey(0)))
    return _PARAMS[arch]


def layer_params(arch: str, i: int):
    """Layer ``i``'s reference leaves (its scan group sliced out)."""
    cfg = ref_configs.get(arch).smoke()
    group, slot = divmod(i, len(cfg.group_pattern))
    return jax.tree.map(lambda a: a[group],
                        ref_params(arch)["layers"][f"slot{slot}"])


def port_model(arch: str, compute_dtype: str = "float32"):
    return lm_from_jax_params(ref_params(arch), cfgs(arch, compute_dtype)[1],
                              "cpu")


def both(arr, dtype: str):
    jdt, tdt = DT[dtype]
    arr = np.asarray(arr, np.float32)
    return jnp.asarray(arr, jdt), torch.from_numpy(arr.copy()).to(tdt)


def close(got, want, tol: float, msg: str = "") -> None:
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32),
        atol=tol, rtol=tol, err_msg=msg)


def close_tree(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for key in want:
        close(got[key], want[key], tol, key)


# -- modules -----------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_matches_reference(dtype):
    xj, xt = both(np.random.default_rng(0).standard_normal((2, 5, 128)) * 3,
                  dtype)
    got = layers.group_norm(xt, 2)
    assert got.dtype == xt.dtype
    close(got, ref_layers.group_norm(xj, 2), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_time_and_channel_mix_match_reference(dtype):
    """A 12-token segment from zero state, then one decode step carrying
    the segment's state: outputs and states."""
    arch = "rwkv6-1.6b"
    rcfg, cfg = cfgs(arch, dtype)
    rp, port = layer_params(arch, 1), port_model(arch, dtype).layers[1]
    x = np.random.default_rng(1).standard_normal((2, 13, cfg.d_model))
    xj, xt = both(x, dtype)
    tol = TOL[dtype]
    with torch.no_grad():
        want, wstate = ref_rwkv.apply_rwkv_tmix(rp["mixer"], xj[:, :12], rcfg,
                                                return_state=True)
        got, gstate = rwkv6.apply_rwkv_tmix(port["mixer"], xt[:, :12], cfg,
                                            return_state=True)
        close(got, want, tol)
        close_tree(gstate, wstate, tol)
        step = {**wstate, "cmix_prev": np.zeros((2, cfg.d_model))}
        want, _ = ref_rwkv.apply_rwkv_tmix(rp["mixer"], xj[:, 12:], rcfg,
                                           state=step)
        got, _ = rwkv6.apply_rwkv_tmix(port["mixer"], xt[:, 12:], cfg,
                                       state=gstate)
        close(got, want, tol)
        want, wc = ref_rwkv.apply_rwkv_cmix(rp["channel"], xj, rcfg,
                                            return_state=True)
        got, gc = rwkv6.apply_rwkv_cmix(port["channel"], xt, cfg,
                                        return_state=True)
        close(got, want, tol)
        close_tree(gc, wc, tol)
        prev = {"cmix_prev": xj[:, 3]}
        want, _ = ref_rwkv.apply_rwkv_cmix(rp["channel"], xj[:, 4:5], rcfg,
                                           state=prev)
        got, _ = rwkv6.apply_rwkv_cmix(port["channel"], xt[:, 4:5], cfg,
                                       state={"cmix_prev": xt[:, 3]})
        close(got, want, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_mixer_and_decode_step_match_reference(dtype):
    """Prefill with its decode state (the conv window holds the last
    d_conv - 1 pre-activation inputs), then three decode steps."""
    arch = "jamba-v0.1-52b"
    rcfg, cfg = cfgs(arch, dtype)
    rp, port = layer_params(arch, 0)["mixer"], port_model(arch,
                                                          dtype).layers[0]
    port = port["mixer"]
    x = np.random.default_rng(2).standard_normal((2, 15, cfg.d_model))
    xj, xt = both(x, dtype)
    tol = TOL[dtype]
    with torch.no_grad():
        want, wstate = ref_mamba.apply_mamba(rp, xj[:, :12], rcfg,
                                             return_state=True)
        got, gstate = mamba.apply_mamba(port, xt[:, :12], cfg,
                                        return_state=True)
        close(got, want, tol)
        close_tree(gstate, wstate, tol)
        for i in range(12, 15):
            want, wstate = ref_mamba.decode_mamba(rp, xj[:, i:i + 1], wstate,
                                                  rcfg)
            got, gstate = mamba.decode_mamba(port, xt[:, i:i + 1], gstate,
                                             cfg)
            close(got, want, tol, f"decode {i}")
            close_tree(gstate, wstate, tol)


def moe_case(arch: str, dtype: str, **moe_overrides):
    rcfg, cfg = cfgs(arch, dtype)
    if moe_overrides:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
            rcfg.moe, **moe_overrides))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_overrides))
    i = cfg.moe_layer_mask().index(True)
    rp = layer_params(arch, i)["channel"]
    port = port_model(arch, dtype).layers[i]["channel"]
    return rcfg, cfg, rp, port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_moe_matches_reference(arch, dtype):
    """Shared experts and their sigmoid gate (qwen2-moe), the plain routed
    layer (jamba), the aux loss."""
    rcfg, cfg, rp, port = moe_case(arch, dtype)
    x = np.random.default_rng(3).standard_normal((2, 12, cfg.d_model))
    xj, xt = both(x, dtype)
    with torch.no_grad():
        got, aux = moe.apply_moe(port, xt, cfg)
    want, want_aux = ref_moe.apply_moe(rp, xj, rcfg)
    close(got, want, TOL[dtype])
    close(aux, want_aux, 1e-5)
    assert ("shared" in port) == (arch == "qwen2-moe-a2.7b")


def test_moe_capacity_drops_overflow_tokens_as_the_reference():
    """A tiny capacity factor: most (token, choice) pairs overflow their
    expert's slots and are dropped, token-major over (T, k), exactly as the
    reference drops them (mirrors tests/test_models.py)."""
    rcfg, cfg, rp, port = moe_case("jamba-v0.1-52b", "float32",
                                   capacity_factor=0.05)
    t = 64
    assert moe.capacity(t, cfg) == ref_moe.capacity(t, rcfg) == 4
    x = np.random.default_rng(4).standard_normal((2, t, cfg.d_model))
    xj, xt = both(x, "float32")
    with torch.no_grad():
        got, aux = moe.apply_moe(port, xt, cfg)
    want, want_aux = ref_moe.apply_moe(rp, xj, rcfg)
    close(got, want, 1e-5)
    close(aux, want_aux, 1e-5)
    # dropped tokens contribute exactly zero
    dead = (np.abs(np.asarray(want)).max(-1) == 0)
    assert dead.sum() > t // 2
    assert (got.abs().amax(-1) == 0).numpy().tolist() == dead.tolist()


def test_moe_ties_break_toward_the_lower_expert():
    """Router columns 1 = 0 and 3 = 2 tie those experts' probabilities
    exactly; both packages take the lower index first."""
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.1], [0.25, 0.25, 0.1, 0.15,
                                                      0.25]])
    _, idx = moe.top_k(probs, 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 4]]
    _, ref_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.asarray(ref_idx).tolist() == idx.tolist()

    rcfg, cfg, rp, port = moe_case("jamba-v0.1-52b", "bfloat16")
    router = np.array(rp["router"])
    router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    rp = {**rp, "router": router}
    with torch.no_grad():
        port["router"].copy_(torch.from_numpy(router))
    x = np.random.default_rng(5).standard_normal((2, 12, cfg.d_model))
    xj, xt = both(x, "bfloat16")
    with torch.no_grad():
        got, aux = moe.apply_moe(port, xt, cfg)
    want, want_aux = ref_moe.apply_moe(rp, xj, rcfg)
    close(got, want, TOL["bfloat16"])
    close(aux, want_aux, 1e-5)


# -- whole models ---------------------------------------------------------------

def logits_runs(arch: str, dtype: str, b=2, t=12, n_decode=4):
    """Prefill then ``n_decode`` decode steps in both packages; yields
    (step, port logits, reference logits)."""
    rcfg, cfg = cfgs(arch, dtype)
    params = ref_params(arch)
    model = port_model(arch, dtype).cast_for_serving()
    ref = RefLM(rcfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (b, t + n_decode))
    want, state = jax.jit(lambda p, x: ref.prefill(p, x, max_len=t + 8))(
        params, jnp.asarray(tokens[:, :t], jnp.int32))
    got, cache = model.prefill(torch.as_tensor(tokens[:, :t]), max_len=t + 8)
    assert got.shape == (b, 1, cfg.vocab_size) and got.dtype == torch.float32
    yield "prefill", got, want
    decode = jax.jit(ref.decode_step)
    for i in range(n_decode):
        tok = tokens[:, t + i:t + i + 1]
        want, state = decode(params, state, jnp.asarray(tok, jnp.int32),
                             jnp.int32(t + i))
        got, cache = model.decode_step(cache, torch.as_tensor(tok), t + i)
        yield f"decode {i}", got, want


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b", "phi4-mini-3.8b",
                                  "phi3-mini-3.8b", "nemotron-4-340b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_prefill_and_decode_logits_match_reference(arch):
    """float32, 1e-4, through the whole model (the dense decoders phi4-mini,
    phi3-mini and nemotron-4 and the MoE phi3.5-moe too)."""
    for step, got, want in logits_runs(arch, "float32"):
        close(got, want, MODEL_TOL["float32"], step)


def test_bf16_logits_stay_within_the_references_rounding():
    """bfloat16 through the whole RWKV-6 model: each step's largest logit
    difference at most 5 % of its largest logit (chip_smoke.py's gate).

    Every sublayer agrees to a bf16 ulp (the test below), but the ulps
    compound along the residual stream: on this prompt the reference's own
    bf16 logits lie 0.06 from its float32 logits (largest logit 3.3), and
    the port's bf16 logits 0.05 from the reference's, so an elementwise
    2e-2 gate on logits would measure bf16 itself."""
    for step, got, want in logits_runs("rwkv6-1.6b", "bfloat16"):
        want = np.asarray(want, np.float32)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel <= 0.05, (step, rel)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b"])
def test_bf16_sublayers_match_reference_on_its_activations(arch):
    """bfloat16: every layer's mixer and channel, fed the reference's own
    activations of a 12-token prompt, within 2e-2 of the reference's
    output.

    The whole model's bf16 logits are compared at 2e-2 nowhere: rounding
    differences of a bf16 ulp compound through the residual stream (see
    above), and where a top-k router reads bf16 logits, experts tie
    exactly, so one ulp upstream flips a tie and moves that token's output
    by O(1): the reference's own bf16 logits lie 1.35 from its float32
    logits on this prompt (jamba smoke).  The float32 whole-model test
    holds the composition.  Attention sublayers are held by
    tests/test_torch_lm.py (the reference's XLA attention rounds q * scale
    and the softmax weights to bf16 where the kernels keep float32)."""
    rcfg, cfg = cfgs(arch, "bfloat16")
    model = port_model(arch, "bfloat16").cast_for_serving()
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12))
    x = ref_layers.embed_tokens(ref_params(arch)["embed"],
                                jnp.asarray(tokens), rcfg)
    positions = jnp.broadcast_to(jnp.arange(12), (2, 12))
    tol = TOL["bfloat16"]
    from repro_torch.models import blocks

    for i, (kind, is_moe) in enumerate(zip(cfg.layer_kinds,
                                           cfg.moe_layer_mask())):
        rp, port = layer_params(arch, i), model.layers[i]
        h = ref_layers.apply_norm(rp["norm1"], x, rcfg)
        if kind == "attn":
            mixed = ref_blocks.full_attention(rp["mixer"], h, rcfg,
                                              positions=positions)
        elif kind == "mamba":
            mixed = ref_mamba.apply_mamba(rp["mixer"], h, rcfg)
        else:
            mixed, _ = ref_rwkv.apply_rwkv_tmix(rp["mixer"], h, rcfg)
        x = x + mixed
        h2 = ref_layers.apply_norm(rp["norm2"], x, rcfg)
        if kind == "rwkv":
            ch, _ = ref_rwkv.apply_rwkv_cmix(rp["channel"], h2, rcfg)
        elif is_moe:
            ch, _ = ref_moe.apply_moe(rp["channel"], h2, rcfg)
        else:
            ch = ref_layers.apply_mlp(rp["channel"], h2, rcfg)
        with torch.no_grad():
            ht, h2t = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                       for a in (h, h2))
            if kind == "mamba":
                got = mamba.apply_mamba(port["mixer"], ht, cfg)
            elif kind == "rwkv":
                got, _ = rwkv6.apply_rwkv_tmix(port["mixer"], ht, cfg)
            if kind != "attn":      # attention: tests/test_torch_lm.py
                close(got, mixed, tol, f"layer {i} {kind}")
            got, _, _ = blocks._channel(port, h2t, cfg, kind, is_moe)
            close(got, ch, tol, f"layer {i} channel")
        x = x + ch


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b"])
def test_greedy_tokens_match_a_jax_greedy_loop(arch):
    rcfg, cfg = cfgs(arch)
    params = ref_params(arch)
    model = port_model(arch)
    batch, prompt_len, gen, seed = 2, 8, 6, 3
    out = serve_session(cfg, batch=batch, prompt_len=prompt_len, gen=gen,
                        seed=seed, model=model)
    ref = RefLM(rcfg)
    prompt = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (batch, prompt_len))
    logits, state = ref.prefill(params, jnp.asarray(prompt, jnp.int32),
                                max_len=prompt_len + gen)
    last = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    want = [last]
    decode = jax.jit(ref.decode_step)
    for i in range(gen - 1):
        logits, state = decode(params, state, last, jnp.int32(prompt_len + i))
        last = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
        want.append(last)
    np.testing.assert_array_equal(out["generated"],
                                  np.asarray(jnp.concatenate(want, axis=1)))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_prefill_then_decode_matches_prefill(arch):
    """logits(prefill(x[:n]) -> decode x[n]) == logits(prefill(x[:n+1]))
    (float32, 1e-4), mirroring the reference's own check: MoE capacity is
    raised so that no token drops (a full pass drops overflowing tokens, a
    one-token decode step never does)."""
    cfg = cfgs(arch)[1]
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    model = build_model(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 16)))
    full, _ = model.prefill(tokens)
    _, state = model.prefill(tokens[:, :15], max_len=20)
    step, _ = model.decode_step(state, tokens[:, 15:], 15)
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b",
                                  "qwen2-moe-a2.7b"])
def test_cast_for_serving_gives_each_leaf_the_dtype_the_reference_reads(arch):
    cfg = cfgs(arch, "bfloat16")[1]
    model = build_model(cfg, device="cpu").cast_for_serving()
    f32 = {"A_log", "D", "dt_bias", "dt_proj", "decay_base", "u",
           "ln_scale", "ln_bias"}
    seen = set()
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        want = (torch.float32 if "norm" in name or leaf in f32
                else torch.bfloat16)
        assert p.dtype == want == serving_dtype(name, cfg), name
        seen.add(leaf)
    kinds = set(cfg.layer_kinds)
    expect = ({"decay_base", "u", "ln_scale", "ln_bias", "wr", "mu"}
              if "rwkv" in kinds else set())
    if "mamba" in kinds:
        expect |= {"A_log", "D", "dt_bias", "dt_proj", "in_proj", "conv_w"}
    if cfg.moe is not None:
        expect |= {"router", "w_in", "w_gate"}
    assert expect <= seen


@pytest.mark.parametrize("arch, mixer", [("rwkv6-1.6b", "rwkv"),
                                         ("jamba-v0.1-52b", "mamba")])
def test_training_a_recurrent_model_gives_a_finite_loss_and_gradients(arch,
                                                                      mixer):
    """The recurrent mixers train (B9 and B7 through their plain backward
    versions here): the loss is finite and every parameter of every layer,
    the scans' float32 leaves included, gets a finite non-zero gradient."""
    cfg = cfgs(arch)[1]
    model = build_model(cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab_size, (1, 8)))
    loss, _ = model.loss({"tokens": tokens, "labels": tokens})
    loss.backward()
    assert torch.isfinite(loss)
    assert mixer in model.kinds
    for name, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


def test_moe_model_trains_on_the_cpu():
    """MoE layers need no scan: the loss and its gradient run, with the
    router's aux loss in the total."""
    cfg = cfgs("qwen2-moe-a2.7b")[1]
    model = build_model(cfg, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 8)))
    loss, parts = model.loss({"tokens": tokens, "labels": tokens})
    loss.backward()
    assert float(parts["aux"].detach()) > 0 and torch.isfinite(loss)
    assert model.layers[0]["channel"]["router"].grad is not None


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-v0.1-52b"])
def test_serve_cli_on_the_cpu(arch):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--batch", "2", "--prompt-len", "8", "--gen", "4",
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "tok/s on cpu" in proc.stderr and "sample tokens" in proc.stderr
