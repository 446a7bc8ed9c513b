"""B9, the wkv6 backward (``csrc/rwkv6_wkv_bwd.cu``, both its programs),
as % of its roofline in the training step: float32 CUDA-core peak and HBM
bytes, the serial form's work."""

from gpubench import counts, readers

ENTRY = "repro_torch.kernels.rwkv6_wkv.ops:wkv6_bwd"
KERNELS = ("wkv_bwd_scans_kernel", "wkv_bwd_chunks_kernel")


def count(r, *args, **kwargs):
    return counts.wkv6_bwd(*r.shape)


def read(view):
    return readers.roofline(view, ENTRY, KERNELS, counts.PEAK_F32_FLOPS)
