"""The yardstick's operation and byte counts against hand-worked cases,
and their independence from the kernels' launch parameters."""

import importlib.util

import pytest
import torch

from conftest import BENCH, ROOT
from gpubench import counts


def test_wkv6_fwd_by_hand():
    # b 1, t 2, h 1, hd 2: 4 cells a token x 2 tokens x 5 FLOPs, and the
    # bonus 4 a channel a token
    flops, nbytes = counts.wkv6_fwd(1, 2, 1, 2)
    assert flops == 5 * 8 + 4 * 4
    # r, k, v, w, y: 4 floats each; u 2; s0, s_T 4 each
    assert nbytes == 4 * (5 * 4 + 2 + 2 * 4)


def test_wkv6_bwd_by_hand():
    flops, nbytes = counts.wkv6_bwd(1, 2, 1, 2)
    assert flops == 14 * 8 + 8 * 4
    # r, k, v, w, dy, dr, dk, dv, dw: 4 floats each; u, du 2; s0, ds_T, ds0 4
    assert nbytes == 4 * (9 * 4 + 2 * 2 + 3 * 4)


def test_attention_by_hand():
    # t 3: pairs (0,0) (1,0) (1,1) (2,0) (2,1) (2,2); two products of hd 4
    flops, nbytes = counts.attention_fwd(1, 3, 1, 4)
    assert flops == 6 * 2 * 2 * 4
    assert nbytes == 2 * 4 * 12 + 4 * 3


def test_roofline_terms_at_the_cells():
    # PERF.md's bytes terms at the training shape
    _, fwd = counts.wkv6_fwd(8, 2048, 32, 64)
    assert fwd / counts.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.2028, abs=1e-4)
    _, bwd = counts.wkv6_bwd(8, 2048, 32, 64)
    assert bwd / counts.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.3644, abs=1e-4)
    assert counts.least_seconds(2.0, 3.35e12, 1.0) == 2.0
    assert counts.least_seconds(1.0, 6.7e12, 1.0) == 2.0


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "qwen2.5-3b"])
def test_model_flops_match_parameter_count(name):
    """Matrix parameters a layer, counted from the widths, equal the port's
    own parameter count less the vectors and the embedding."""
    import json

    from gpubench.harness import port_arch
    from repro_torch.models.lm import LM

    arch = json.loads((ROOT / "gpubench" / "configs" / f"{name}.json")
                      .read_text())["arch"]
    model = LM(port_arch(arch), device="meta")
    matrices = sum(p.numel() for n, p in model.named_parameters()
                   if p.dim() >= 2 and not n.startswith("embed.")
                   and n.rsplit(".", 1)[-1] not in ("mu", "u", "bq", "bk",
                                                    "bv"))
    assert counts.matrix_params(arch) == matrices
    assert counts.head_params(arch) == arch["d_model"] * arch["vocab_size"]


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "gpubench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,launch", [
    ("wkv6_fwd_roofline.train", [{}, {"chunk": 32, "split": 2},
                                 {"chunk": 64, "block_h": 2}]),
    ("wkv6_bwd_roofline.train", [{}, {"chunk": 32, "block_threads": 256},
                                 {"parts": 2, "cols": 8}]),
    ("flash_attention_fwd_roofline.prefill",
     [{}, {"block_q": 64, "block_k": 128}, {"stages": 3, "causal": True}]),
])
def test_counts_ignore_launch_parameters(name, launch):
    mod = _metric(name)
    x = torch.empty(2, 256, 4, 64, device="meta", dtype=torch.bfloat16)
    args = (x,) * 3 if "attention" in name else (x,) * 8
    got = {mod.count(*args, **kw) for kw in launch}
    assert len(got) == 1
    assert all(v > 0 for v in got.pop())


def test_every_kernel_metric_names_kernels_the_port_builds():
    from gpubench import readers
    for m in BENCH["per_layer"]:
        mod = _metric(m["name"])
        for k in getattr(mod, "KERNELS", ()):
            assert k in readers.PORT_KERNELS
            assert k in "".join(p.read_text() for p in (
                ROOT / "src/repro_torch/kernels/csrc").glob("*.cu*"))
