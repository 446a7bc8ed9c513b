"""What the per-layer metrics share: device time of named kernels, and a
kernel's share of its roofline over the traced window's calls."""

from __future__ import annotations

from gpubench import counts
from gpubench import devtrace as tr

# every kernel the port builds (``src/repro_torch/kernels/csrc``): what is
# not one of these, not a cuBLAS product and not a copy is PyTorch's own
PORT_KERNELS = (
    "state_map_vec_kernel", "state_map_gather_kernel", "count_hits_kernel",
    "flash_fwd_bf16_kernel", "flash_fwd_f32_kernel",
    "flash_bwd_dq_bf16_kernel", "flash_bwd_dkv_bf16_kernel",
    "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
    "decode_bf16_kernel", "decode_f32_kernel",
    "scan_fwd_kernel", "scan_bwd_summaries_kernel", "scan_bwd_carry_kernel",
    "scan_bwd_chunks_kernel",
    "wkv_serial_kernel", "wkv_fwd_states_kernel", "wkv_bwd_scans_kernel",
    "wkv_bwd_chunks_kernel")


def named(acts, names) -> list:
    return [a for a in acts if any(n in a.name for n in names)]


def seconds(acts) -> float:
    return sum(a.end - a.start for a in acts) / 1e9


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def roofline(view, entry: str, kernels, peak_flops: float) -> float | None:
    """% of the least time the card could take over every call of
    ``entry`` in the window (``counts.least_seconds`` of each call's
    operations and bytes), against its kernels' device time there."""
    calls = view.calls.get(entry) or []
    spent = seconds(named(view.acts, kernels))
    if not calls or spent <= 0:
        return None
    least = sum(counts.least_seconds(f, b, peak_flops) for f, b in calls)
    return 100.0 * least / spent


def per_unit_ms(view, acts) -> float | None:
    if view.units <= 0:
        return None
    return 1e3 * seconds(acts) / view.units


def idle_share(view) -> float | None:
    span = view.hi - view.lo
    if span <= 0 or not view.acts:
        return None
    return 100.0 * (1.0 - tr.busy_ns(tr.clip(view.acts, view.lo, view.hi))
                    / span)


def mfu(view, peak_flops: float = counts.PEAK_BF16_FLOPS) -> float | None:
    """% of the card's peak that the window's units outside the trace
    reached: their model FLOPs over their host-clock seconds (none where
    the trace saw nothing run on a card)."""
    if not view.acts or view.host.get("units", 0) <= 0 \
            or view.host["seconds"] <= 0:
        return None
    return 100.0 * view.host["flops"] / view.host["seconds"] / peak_flops
