"""B8, the wkv6 forward (``kernels/rwkv6_wkv`` -> ``csrc/rwkv6_wkv.cu``,
both its programs), as % of its roofline in the training step: float32
CUDA-core peak and HBM bytes, the recurrence's serial form."""

from gpubench import counts, readers

ENTRY = "repro_torch.kernels.rwkv6_wkv.ops:wkv6_fwd"
KERNELS = ("wkv_fwd_states_kernel", "wkv_serial_kernel")


def count(r, *args, **kwargs):
    return counts.wkv6_fwd(*r.shape)


def read(view):
    return readers.roofline(view, ENTRY, KERNELS, counts.PEAK_F32_FLOPS)
