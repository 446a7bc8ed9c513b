"""The correctness check at a size a test run holds (CPU, tiny widths):
sound runs pass, the float8 control fails, and each fault the cells can
have, planted under the timed path of a whole run, comes out not correct.

The limits here are set for the tiny widths from their own readings
(``readings.py`` at this size): bf16 rounding is larger relative to a
64-wide model than to the cells' 2048-wide ones, so the cells' own limits
(``workloads/*.json``, set at full size on the card) do not apply.
"""

import json

import pytest

from conftest import BENCH, PREFILL, TRAIN, edit
from gpubench import harness, readings

TINY_LIMITS = {
    TRAIN: {"loss_rel": 1e-3, "grad_gap_median": 5e-3,
            "update_gap_median": 2.5e-3},
    PREFILL: {"logit_gap": 0.3, "logits_rel": 0.05, "state_rel": 0.04},
}
FAULTS = {TRAIN: ["half_batch", "state_unchanged"],
          PREFILL: ["half_batch", "token_altered"]}


@pytest.fixture
def tree(tiny_tree):
    for name, limits in TINY_LIMITS.items():
        edit(tiny_tree / "workloads" / f"{name}.json", limits=limits)
    return tiny_tree


def run(tree, name, fault=None):
    with (readings.FAULTS[fault]() if fault else
          __import__("contextlib").nullcontext()):
        result, checks = harness.run_cell(name, 1, 0.3, False, device="cpu",
                                          bench=BENCH, root=tree)
    return result


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_sound_run_is_correct(tree, name):
    result = run(tree, name)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name,fault", [(n, f) for n in FAULTS
                                        for f in FAULTS[n]])
def test_fault_under_the_timed_path_is_caught(tree, name, fault):
    result = run(tree, name, fault)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_control_fails_a_limit(tree, name):
    cell, kind = harness.load_cell(BENCH, name, 1, "cpu", tree)
    read = readings.train_readings if name == TRAIN \
        else readings.prefill_readings
    prog, control = read(cell, kind, True)
    limits = TINY_LIMITS[name]
    assert all(prog[k] <= limits[k] for k in limits), prog
    assert any(control[k] > limits[k] for k in limits), control
    # and by a margin: the control reads 3x the program on some number
    assert any(control[k] >= 3 * max(prog[k], 1e-12) for k in limits)
