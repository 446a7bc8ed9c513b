"""The harness is driven by files: a cell, a configuration, a traffic mix
and a per-layer metric added as files (and ``BENCHMARK.json`` entries)
run with no edit to any file already there; the result line has the
contract's keys; a run without a card prints no result."""

import copy
import json
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, TRAIN, PREFILL
from gpubench import harness

NEW = "tiny-rwkv.train.2x24"


def add_cell(tree) -> dict:
    """A new configuration, mix, cell and metric, as new files only."""
    cfg = json.loads((tree / "configs" / "rwkv6-1.6b.json").read_text())
    cfg["arch"]["name"] = "tiny-rwkv"
    cfg["arch"]["n_layers"] = 1
    cfg["arch"]["layer_kinds"] = ["rwkv"]
    (tree / "configs" / "tiny-rwkv.json").write_text(json.dumps(cfg))
    mix = json.loads((tree / "traffic" / "train.24x2048.json").read_text())
    mix.update(batch=2, seq_len=24, traced_units=3)
    (tree / "traffic" / "train.2x24.json").write_text(json.dumps(mix))
    (tree / "workloads" / f"{NEW}.json").write_text(json.dumps(
        {"limits": {"loss_rel": 1.0, "grad_gap_median": 1.0,
                    "update_gap_median": 1.0}}))
    (tree / "metrics" / "traced_steps.train.py").write_text(
        '"""Steps the trace holds."""\n\n\ndef read(view):\n'
        '    return float(view.units)\n')
    bench = copy.deepcopy(BENCH)
    bench["configs"].append({"name": "tiny-rwkv", "source": "test",
                             "file": "gpubench/configs/tiny-rwkv.json",
                             "reduced": ["n_layers"], "why": "test"})
    bench["workloads"].append({"name": NEW, "config": "tiny-rwkv",
                               "traffic": "train.2x24", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s":
            m["workloads"].append(NEW)
    bench["per_layer"].append({"name": "traced_steps.train", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "test", "moves": "train_tokens_per_s",
                               "workloads": [NEW]})
    return bench


def test_new_cell_config_mix_and_metric_are_files(tiny_tree):
    before = {p: p.read_bytes() for p in tiny_tree.rglob("*") if p.is_file()}
    bench = add_cell(tiny_tree)
    result, _ = harness.run_cell(NEW, 9, 0.2, False, device="cpu",
                                 bench=bench, root=tiny_tree)
    assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}
    assert result["correct"] and result["attempted"] >= 1
    traced, _ = harness.run_cell(NEW, 9, 0.2, True, device="cpu",
                                 bench=bench, root=tiny_tree)
    assert traced["metrics"]["traced_steps.train"]["value"] == 3.0
    # the other cells' metrics are not this cell's
    assert not set(traced["metrics"]) & {"mfu.prefill",
                                         "launches.train"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny_tree, name, trace):
    result, checks = harness.run_cell(name, 2 ** 31 + 11, 0.2, trace,
                                      device="cpu", bench=BENCH,
                                      root=tiny_tree)
    keys = list(result)
    assert keys[:3] == ["correct", "attempted", "failed"]
    assert keys[-1] == "checks"
    assert {"metrics", "device"} <= set(keys)
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        e2e = {m["name"] for m in harness.cell_metrics(BENCH, name,
                                                        "end_to_end")}
        assert set(result["metrics"]) == e2e
    for c in checks:
        assert result["checks"][c.name] == {"value": c.value,
                                            "limit": c.limit}
    json.dumps(result)


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints nothing on
    standard output; so it does from a folder holding only
    ``BENCHMARK.json`` and ``gpubench/`` (no port)."""
    import shutil
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    args = ["--workload", TRAIN, "--seed", "5", "--seconds", "1",
            "--trace", "0"]
    out = subprocess.run([sys.executable, "gpubench/run.py", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "is_available() is False" in out.stderr
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "gpubench/run.py", *args],
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_cell_runs_on_the_card(card):
    """One short run of each cell where a card is (the chip)."""
    for name in (TRAIN, PREFILL):
        out = subprocess.run(
            [sys.executable, "gpubench/run.py", "--workload", name,
             "--seed", "3", "--seconds", "5", "--trace", "0"],
            cwd=ROOT, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_benchmark_json_matches_its_files():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["arch"]["name"] == c["name"]
        assert data["source"] == c["source"] or c["source"] in data["source"]
        assert data["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert (ROOT / "gpubench" / "workloads" / f"{w['name']}.json").exists()
        assert (ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["per_layer"]:
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").exists()
