"""The float32 gradient gate's premise, read on the CPU (ROADMAP C3).

The RWKV-6 training gates on the card hold each parameter's float32
gradient to a float64 pass, at 1.5 x the plain float32 path's own distance
where that is above 1e-3: a random-weight RWKV-6 computes many of its
gradients in float32 only to ~1e-2.  Here the reference's own float32 is
read against float64 on the same weights: ``jax.value_and_grad`` of the
JAX package's ``LM.loss`` in float32, and under ``jax.enable_x64(True)``
with the weights and the compute dtype in float64.  The reference cannot
run that pass as it stands (``wkv_scan`` carries a float32 state, and the
float64 decay makes the carry float64), so its recurrence is swapped for the
package's own oracle ``wkv6_ref`` in float64 for that pass; the loss's
cross-entropy and the wkv inputs keep the model's own float32 casts.

The cut is RWKV-6's smoke width (d 128, two heads of 64) at 8 layers and
2 x 256 tokens, seed 0: the shallowest where the port's plain float32 lies
more than 1e-3 from float64 (at 4 layers and 256 tokens it is ~7e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.rwkv6 as ref_rwkv6
from repro import configs as ref_configs
from repro.kernels.rwkv6_wkv.ref import wkv6_ref
from repro.models import LM as RefLM
from repro_torch import configs
from repro_torch.convert import _reference_leaf, lm_from_jax_params

LAYERS, B, T, SEED = 8, 2, 256, 0


def _cfgs():
    kw = dict(compute_dtype="float32", n_layers=LAYERS,
              layer_kinds=("rwkv",) * LAYERS)
    return (dataclasses.replace(configs.get("rwkv6-1.6b").smoke(), **kw),
            dataclasses.replace(ref_configs.get("rwkv6-1.6b").smoke(), **kw))


def _wkv64(r, k, v, w, u, s0=None):
    f64 = lambda x: x.astype(jnp.float64)  # noqa: E731
    b, _, h, hd = r.shape
    s0 = jnp.zeros((b, h, hd, hd), jnp.float64) if s0 is None else f64(s0)
    return wkv6_ref(f64(r), f64(k), f64(v), f64(w), f64(u), s0)


def _kind(name: str) -> str:
    """A parameter: one name in every layer (``layers.3.mixer.u`` ->
    ``mixer.u``)."""
    parts = name.split(".")
    return ".".join(parts[2:]) if parts[0] == "layers" else name


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_port_float32_gradients_are_as_close_to_float64_as_the_references(
        monkeypatch):
    port_cfg, ref_cfg = _cfgs()
    params = RefLM(ref_cfg).init(jax.random.PRNGKey(SEED))
    toks = np.random.default_rng(SEED).integers(0, ref_cfg.vocab_size,
                                                (B, T + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}

    def grads(cfg, p):
        fn = jax.value_and_grad(lambda q, b: RefLM(cfg).loss(q, b),
                                has_aux=True)
        _, g = fn(p, {k: jnp.asarray(v) for k, v in batch.items()})
        return jax.tree.map(lambda x: np.asarray(x, np.float64), g)

    ref32 = grads(ref_cfg, params)
    with jax.enable_x64(True):
        monkeypatch.setattr(ref_rwkv6, "wkv_scan", _wkv64)
        ref64 = grads(dataclasses.replace(ref_cfg, compute_dtype="float64"),
                      jax.tree.map(lambda x: jnp.asarray(x, jnp.float64),
                                   params))
        monkeypatch.undo()
    model = lm_from_jax_params(jax.tree.map(np.asarray, params), port_cfg,
                               "cpu")
    loss, _ = model.loss({k: torch.from_numpy(v) for k, v in batch.items()},
                         remat=True)
    loss.backward()

    port, ref = {}, {}
    for name, p in model.named_parameters():
        want = _reference_leaf(ref64, name, port_cfg)
        kind = _kind(name)
        port[kind] = max(port.get(kind, 0.0),
                         _rel(p.grad.double().numpy(), want))
        ref[kind] = max(ref.get(kind, 0.0),
                        _rel(_reference_leaf(ref32, name, port_cfg), want))
    # the cut shows the effect the gate rests on ...
    assert max(port.values()) > 1e-3 and max(ref.values()) > 1e-3, (port, ref)
    # ... and the port's float32 is no farther from float64 than the
    # reference's own, parameter by parameter
    over = {k: (port[k], ref[k]) for k in port if port[k] > 1.5 * ref[k] + 1e-4}
    assert not over, over
