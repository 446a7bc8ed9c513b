"""B3, the flash-attention forward (``kernels/flash_attention`` ->
``csrc/flash_attention.cu``), as % of its roofline in prefill: bf16
tensor-core peak and HBM bytes, causal attention's two products."""

from gpubench import counts, readers

ENTRY = "repro_torch.kernels.flash_attention.ops:flash_attention_fwd"
KERNELS = ("flash_fwd_bf16_kernel", "flash_fwd_f32_kernel")


def count(q, *args, **kwargs):
    return counts.attention_fwd(*q.shape, elem=q.element_size())


def read(view):
    return readers.roofline(view, ENTRY, KERNELS, counts.PEAK_BF16_FLOPS)
