"""The trace arithmetic on synthetic events: the union of overlapping
device intervals, time under a host range, the idle gaps."""

import pytest

from conftest import BENCH, ROOT  # noqa: F401
from gpubench import devtrace as tr
from gpubench import readers
from gpubench.harness import View


def acts():
    # two streams: kernels overlap; a copy inside a kernel
    return [tr.Activity("k1", 0, 100, ((1, 5),)),
            tr.Activity("k2", 50, 150, ((1, 40),)),
            tr.Activity("Memcpy DtoD", 60, 70, ((1, 41),)),
            tr.Activity("gemm_kernel", 300, 400, ((1, 250),)),
            tr.Activity("k3", 390, 500, ((1, 260),))]


def test_union_counts_overlap_once():
    assert tr.union([(0, 100), (50, 150), (60, 70), (300, 400),
                     (390, 500)]) == [(0, 150), (300, 500)]
    assert tr.busy_ns([(0, 100), (50, 150), (60, 70)]) == 150
    # a sum of durations would read 320 over this window, more than it is
    assert tr.busy_ns(tr.clip(acts(), 0, 600)) == 350
    assert tr.busy_ns(tr.clip(acts(), 120, 350)) == 30 + 50


def test_window_range_and_launches_inside_a_range():
    t = tr.Trace(acts(), {tr.WINDOW_RANGE: [(1, 0, 600)],
                          "adamw": [(1, 200, 280)]},
                 [(0, 600, "step"), (240, 270, "aten::mul")])
    found, lo, hi = tr.in_window(t)
    assert (lo, hi) == (0, 600) and len(found) == 5
    inside = tr.launched_in(t, "adamw", found)
    assert [a.name for a in inside] == ["gemm_kernel", "k3"]
    assert tr.launched_in(t, "absent", found) == []


def test_idle_gaps_name_the_innermost_host_op():
    t = tr.Trace(acts(), {tr.WINDOW_RANGE: [(1, 0, 600)]},
                 [(0, 600, "step"), (140, 290, "aten::copy_")])
    gaps = dict(tr.idle_gaps(t, acts(), 0, 600))
    assert gaps["aten::copy_"] == pytest.approx(150e-9)
    assert gaps["step"] == pytest.approx(100e-9)


def test_share_readers():
    t = tr.Trace(acts(), {tr.WINDOW_RANGE: [(1, 0, 600)]}, [])
    v = View(t, acts(), 0, 600, units=2,
             calls={"m:f": [(1e9, 0.0), (1e9, 0.0)]},
             host={"seconds": 1.0, "flops": 989e12 * 0.25, "units": 3})
    assert readers.idle_share(v) == pytest.approx(100 * (1 - 350 / 600))
    assert readers.mfu(v) == pytest.approx(25.0)
    # 2e9 FLOPs at 1e12/s = 2 ms of k1+k2's 200 ns? the share is least/spent
    share = readers.roofline(v, "m:f", ("k1", "k2"), 1e18)
    assert share == pytest.approx(100 * 2e-9 / 200e-9)
    assert readers.roofline(v, "m:absent", ("k1",), 1e12) is None
    assert readers.roofline(v, "m:f", ("nothing",), 1e12) is None
    empty = View(tr.Trace([], {}, []), [], 0, 600, units=2)
    assert readers.idle_share(empty) is None and readers.mfu(empty) is None
