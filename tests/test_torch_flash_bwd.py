"""Kernel B5 (flash-attention backward) of the port on the CPU: its plain
PyTorch version held against ``jax.vjp`` of the JAX package's
``attention_ref`` on the same numpy-seeded inputs, the
``torch.autograd.Function`` around B3 and B5 against torch autograd of the
port's own ``attention_ref``, and the wrapper's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch import _build
from repro_torch.kernels import SMEM_LIMIT_BYTES
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.attention import _repeat_kv

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# float32: the reference's kernel gate (tune/kernels/specs.py); bfloat16:
# 2e-2 of the largest |grad| (evaluate.py's rule for sub-4-byte floats:
# both sides round dq/dk/dv to bf16 from float32 sums taken in another
# order, and the reference's delta uses o before it is rounded to bf16)
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


def both(arr: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return (jnp.asarray(arr, jdt),
            torch.from_numpy(np.asarray(arr, np.float32)).to(tdt))


@pytest.mark.parametrize("b,tq,tk,h,hd,causal,q_offset,dtype", [
    (2, 64, 64, 2, 32, True, 0, "float32"),
    (1, 48, 48, 3, 64, False, 0, "float32"),
    (2, 33, 33, 2, 32, True, 0, "float32"),       # ragged T
    (1, 16, 40, 2, 32, True, 24, "float32"),      # q_offset = Tk - Tq
    (1, 17, 29, 2, 16, False, 0, "float32"),      # Tq != Tk, full
    (2, 64, 64, 2, 32, True, 0, "bfloat16"),
    (1, 33, 33, 4, 64, True, 0, "bfloat16"),
    (1, 16, 40, 2, 32, True, 24, "bfloat16"),
    (1, 33, 45, 2, 192, True, 12, "bfloat16"),    # hd 192, ragged, q_offset
])
def test_bwd_plain_matches_jax_vjp(b, tq, tk, h, hd, causal, q_offset, dtype):
    rng = np.random.default_rng(17)
    (qj, qt), (doj, dot) = (both(rng.standard_normal((b, tq, h, hd)), dtype)
                            for _ in range(2))
    (kj, kt), (vj, vt) = (both(rng.standard_normal((b, tk, h, hd)), dtype)
                          for _ in range(2))
    _, vjp = jax.vjp(lambda q, k, v: jax_attention_ref(
        q, k, v, causal=causal, q_offset=q_offset), qj, kj, vj)
    want = vjp(doj)
    o, lse = fa_kernel.flash_attention_fwd_plain(qt, kt, vt, causal=causal,
                                                 q_offset=q_offset)
    got = fa_kernel.flash_attention_bwd(qt, kt, vt, o, lse, dot,
                                        causal=causal, q_offset=q_offset)
    tol = TOL[dtype]
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        assert g.dtype == qt.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w,
                                   atol=tol * max(np.abs(w).max(), 1.0),
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("tq,tk,q_offset,kv", [
    (32, 32, 0, 4), (45, 45, 0, 2), (12, 40, 28, 1)])
def test_autograd_function_matches_torch_autograd(tq, tk, q_offset, kv):
    """Gradients through ``ops.flash_attention`` (B3 forward, B5 backward)
    reach q and the repeated k/v heads: the same as torch autograd of the
    port's ``attention_ref`` (1e-5: both float32)."""
    rng = np.random.default_rng(23)
    b, h, hd = 2, 4, 32

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_()

    q, k, v = leaf(b, tq, h, hd), leaf(b, tk, kv, hd), leaf(b, tk, kv, hd)
    do = torch.from_numpy(rng.standard_normal((b, tq, h, hd))
                          .astype(np.float32))
    grads = []
    for attend in (fa_ops.flash_attention, attention_ref):
        out = attend(q, _repeat_kv(k, h), _repeat_kv(v, h), causal=True,
                     q_offset=q_offset)
        grads.append(torch.autograd.grad(out, (q, k, v), do))
    for name, g, w in zip(("dq", "dk", "dv"), *grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_autograd_takes_do_as_a_strided_view():
    """``do`` arrives as a view of the output projection's gradient; the
    Function hands the kernel a contiguous copy, and the numbers do not
    depend on the view."""
    rng = np.random.default_rng(29)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 24, 2, 16)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    out = fa_ops.flash_attention(q, k, v, causal=True)
    base = torch.from_numpy(rng.standard_normal((1, 2, 24, 16))
                            .astype(np.float32))
    do = base.transpose(1, 2)
    assert not do.is_contiguous()
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True),
                               (q, k, v), do.contiguous())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=1e-5)


def test_no_graph_without_grad():
    """Without autograd the op is the forward kernel alone."""
    q = torch.zeros((1, 8, 2, 16), requires_grad=True)
    with torch.no_grad():
        out = fa_ops.flash_attention(q, q, q)
    assert out.grad_fn is None and not out.requires_grad
    out = fa_ops.flash_attention(q, q, q)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


def bwd_inputs(b=1, t=16, h=2, hd=128, dtype=torch.float32):
    q = torch.zeros((b, t, h, hd), dtype=dtype)
    lse = torch.zeros((b, h, t))
    return q, q, q, q, lse, q


@pytest.mark.parametrize("dtype, bad, match", [
    # float32 (the parity path): 4 x 4 micro-tiles, float32 tiles
    (torch.float32, dict(block_q=6), "multiple of 4"),
    (torch.float32, dict(block_threads=1024), r"\[32, 512\]"),
    (torch.float32, dict(block_threads=48), "block_threads"),
    (torch.float32, dict(block_q=64, block_k=128), "shared memory"),
    (torch.float32, dict(block_q=128, block_k=128), "shared memory"),
    # bfloat16 (the tensor cores): a warp per 16 rows in both programs
    (torch.bfloat16, dict(block_q=24, block_k=24, block_threads=48),
     "multiple of 16"),
    (torch.bfloat16, dict(block_q=64, block_k=64, block_threads=256),
     r"2 \* block_q"),
    (torch.bfloat16, dict(block_q=32, block_k=64, block_threads=64),
     "must equal block_q"),
    (torch.bfloat16, dict(block_q=256, block_k=256, block_threads=512),
     "at most 256"),
])
def test_bwd_wrapper_refuses_bad_launch_parameters(dtype, bad, match):
    launch = (fa_ops.BWD_DEFAULTS if dtype == torch.bfloat16
              else fa_ops.BWD_F32_DEFAULTS)
    kw = {**launch, **bad}
    with pytest.raises(ValueError, match=match):
        fa_kernel.flash_attention_bwd(*bwd_inputs(dtype=dtype), **kw)


def test_bwd_wrapper_refuses_bad_tensors():
    q, k, v, o, lse, do = bwd_inputs(hd=32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa_kernel.flash_attention_bwd(q.double(), k, v, o, lse, do)
    with pytest.raises(ValueError, match="do must be like q"):
        fa_kernel.flash_attention_bwd(q, k, v, o, lse, do[:, :8])
    with pytest.raises(ValueError, match="o must be like q"):
        fa_kernel.flash_attention_bwd(q, k, v, o.bfloat16(), lse, do)
    with pytest.raises(ValueError, match="lse must be"):
        fa_kernel.flash_attention_bwd(q, k, v, o, lse.transpose(1, 2), do)
    with pytest.raises(ValueError, match="contiguous along hd"):
        fa_kernel.flash_attention_bwd(q, k, v, o, lse,
                                      torch.zeros((1, 16, 2, 64))[..., ::2])
    with pytest.raises(ValueError, match="already repeated"):
        fa_kernel.flash_attention_bwd(q, k[:, :, :1], v[:, :, :1], o, lse, do)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_smem_accounting_and_defaults(dtype):
    """Each build's layout at hd 128.  float32: its tiles are float32 in
    shared memory; 32 x 64 fits and 64 x 64 fills all the card gives a
    block.  bfloat16: the fragments and accumulators live in registers;
    dq keeps a two-slot ring of k and v tiles, dk/dv its v tile and a
    two-slot ring of q and do tiles with their lse and delta rows."""
    hd = 128
    launch = (fa_ops.BWD_DEFAULTS if dtype == torch.bfloat16
              else fa_ops.BWD_F32_DEFAULTS)
    assert fa_kernel.smem_bytes_bwd(launch["block_q"], launch["block_k"], hd,
                                    dtype) <= SMEM_LIMIT_BYTES
    if dtype == torch.float32:
        assert launch == {"block_q": 32, "block_k": 64, "block_threads": 256}
        assert fa_kernel.smem_bytes_bwd(32, 64, hd) == 4 * (
            2 * hd * 65 + 2 * hd * 33 + 2 * 32 * 65 + 2 * 64 * hd + 2 * 32)
        assert fa_kernel.smem_bytes_bwd(64, 64, hd) == SMEM_LIMIT_BYTES
        # the forward's bfloat16 default does not fit here
        assert fa_kernel.smem_bytes_bwd(64, 128, hd) > SMEM_LIMIT_BYTES
    else:
        assert launch["block_threads"] == 2 * launch["block_q"] \
            == 2 * launch["block_k"]
        ld = hd + 8
        assert fa_kernel.smem_bytes_bwd(64, 64, hd, dtype) == max(
            2 * 2 * 64 * ld * 2, 64 * ld * 2 + 2 * (2 * 64 * ld * 2 + 2 * 64 * 4))
        # the largest block (8 warps) fits every built head_dim up to 128;
        # hd 192 (dq also stages its do rows) is cut to 64 x 64
        for d in fa_kernel.BWD_BF16_HEAD_DIMS:
            fit = fa_kernel.fit_bwd_launch(dtype, d)
            assert fa_kernel.smem_bytes_bwd(fit["block_q"], fit["block_k"], d,
                                            dtype) <= SMEM_LIMIT_BYTES
            assert fit == (launch if d <= 128 else {
                "block_q": 64, "block_k": 64, "block_threads": 128})
        assert fa_kernel.smem_bytes_bwd(64, 64, 192, dtype) == max(
            2 * 2 * 64 * 200 * 2 + 64 * 200 * 2,
            64 * 200 * 2 + 2 * (2 * 64 * 200 * 2 + 2 * 64 * 4))


def test_a_tensor_off_the_cpu_takes_the_kernel_or_raises(monkeypatch):
    """A tensor that is not on the CPU goes to the CUDA kernel; where the
    kernel cannot be built the wrapper raises, it does not fall back."""
    def no_nvcc():
        raise _build.KernelBuildError("nvcc not found")

    monkeypatch.setattr(_build, "find_nvcc", no_nvcc)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(fa_kernel, "_lib_bwd", None)
    monkeypatch.setattr(_build, "build_dir", lambda: _build.Path("/nonexistent"))
    before = (fa_kernel.flash_attention_bwd.launches,
              dict(fa_kernel.flash_attention_bwd.program_launches))
    q, k, v, o, lse, do = (x.to("meta") for x in bwd_inputs(hd=32))
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        fa_kernel.flash_attention_bwd(q, k, v, o, lse, do)
    assert (fa_kernel.flash_attention_bwd.launches,
            fa_kernel.flash_attention_bwd.program_launches) == before
