"""Each plain reference at tiny widths against the port's CPU path (its
kernels' plain PyTorch versions), both in float32: the same weights and
tokens give the same loss, gradients, last logits and prefill states."""

import json

import pytest
import torch

from conftest import ROOT, TINY_ARCH
from gpubench import weights
from gpubench.harness import port_arch
from gpubench.reference import dense, rwkv6

FAMILIES = {"rwkv6-1.6b": rwkv6, "qwen2.5-3b": dense}


def tiny(name: str) -> dict:
    arch = json.loads((ROOT / "gpubench" / "configs" / f"{name}.json")
                      .read_text())["arch"]
    arch.update(TINY_ARCH[name], compute_dtype="float32")
    return arch


def port_model(arch: dict, w: dict):
    from repro_torch.models.lm import LM
    model = LM(port_arch(arch), device="meta")
    model.load_state_dict({n: t.clone() for n, t in w.items()}, strict=True,
                          assign=True)
    return model


def rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_and_gradients_match_the_port(name):
    arch, ref = tiny(name), FAMILIES[name]
    w = weights.make(ref.leaves(arch), 3, "cpu")
    model = port_model(arch, w)
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, arch["vocab_size"], (2, 41), generator=gen)
    tokens, labels = x[:, :-1], x[:, 1:]
    loss_p, _ = model.loss({"tokens": tokens, "labels": labels}, remat=True)
    loss_p.backward()
    params = {n: t.clone().requires_grad_() for n, t in w.items()}
    loss_r = ref.loss(params, tokens, labels, arch)
    loss_r.backward()
    assert float(loss_p) == pytest.approx(float(loss_r), rel=1e-5)
    for n, p in model.named_parameters():
        assert rel(p.grad, params[n].grad) < 1e-4, n


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_prefill_matches_the_port(name):
    arch, ref = tiny(name), FAMILIES[name]
    w = weights.make(ref.leaves(arch, serving=True), 5, "cpu")
    model = port_model(arch, w)
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, arch["vocab_size"], (3, 37), generator=gen)
    logits_p, states_p = model.prefill(tokens, max_len=38)
    logits_r, states_r, hidden_r = ref.prefill(w, tokens, arch)
    assert rel(ref.logits(w, hidden_r[:, -1], arch), logits_r) < 1e-6
    assert rel(logits_p[:, -1], logits_r) < 1e-5
    assert len(states_p) == len(states_r) == arch["n_layers"]
    for sp, sr in zip(states_p, states_r):
        for key, t in sr.items():
            got = sp[key][:, :37] if key in ("k", "v") else sp[key]
            assert rel(got, t) < 1e-5, key


def test_rwkv6_recurrence_chunked_against_the_serial_form():
    """The reference's chunked wkv against the recurrence written out token
    by token, with decays from nearly 1 to exactly 0 and a ragged T."""
    gen = torch.Generator().manual_seed(7)
    b, t, h, hd = 2, 45, 3, 8
    r, k, v = (torch.randn(b, t, h, hd, generator=gen) for _ in range(3))
    logw = -torch.rand(b, t, h, hd, generator=gen) * 5
    logw[0, 3:9] = -20.0                        # w ~ 2e-9: the state forgets
    u = torch.randn(h, hd, generator=gen)
    y, s_t = rwkv6.wkv(r, k, v, logw, u)
    s = torch.zeros(b, h, hd, hd)
    for i in range(t):
        kv = k[:, i, :, :, None] * v[:, i, :, None, :]
        want = (r[:, i, :, :, None] * (s + u[None, :, :, None] * kv)).sum(2)
        assert torch.allclose(y[:, i], want, atol=1e-4), i
        s = logw[:, i].exp()[..., None] * s + kv
    assert torch.allclose(s_t, s, atol=1e-4)


def test_control_rounds_to_float8():
    from gpubench.reference import common
    x = torch.randn(64, 64)
    q = common.fp8(x)
    # e4m3 keeps 3 mantissa bits: about 6 % relative, far from bf16's 0.4 %
    assert 0.01 < rel(q, x) < 0.1
    assert torch.equal(common.mm(x, x, None), x @ x)
    # the gradient that flows back is rounded too, to e5m2 (2 bits)
    g = torch.randn(64, 64)
    x.requires_grad_()
    (common.fp8(x) * g).sum().backward()
    assert 0.02 < rel(x.grad, g) < 0.2
    assert rel(x.grad, g) > 1.5 * rel(q, x)
