"""The port's twins of the reference's examples (``examples/torch_*.py``)
held against the examples themselves (``examples/*.py``) on the CPU, with
the same inputs; and ``docs/port.md``'s module table against the
reference's modules.

* quickstart: the printed lines, line for line, both surrogates cut the
  same way to 20 trees a model (the reference's scalar SAML chain
  predicts one row at a time: ~25 s at its 150 trees);
* dna_autotune (simulated): the printed lines, line for line, both cut the
  same way to one dataset and 20 trees a surrogate (~75 s for one dataset
  at 150 trees);
* dna_autotune ``--real`` on the CPU: every measured configuration's count
  against the reference's ``fa_match_ref`` on the same text (cut to 2^16
  symbols, where it holds two matches: the plain versions step each
  chunk's positions in Python);
* train_lm ``tiny``: the reference's lines, and with the reference's
  initial parameters carried across (``convert.lm_from_jax_params``) its
  first 10 losses in float32 compute within the gate of
  ``test_torch_train.py::test_train_loop_matches_three_reference_steps``
  (atol = rtol = 1e-4);
* serve_lm: the tokens of ``serve_session`` for the same seed;
* elastic_restart: two CPU gloo ranks, both phases against an
  uninterrupted two-rank run.
"""

from __future__ import annotations

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core
from repro import configs as ref_configs
from repro.kernels.dna_automaton.ref import fa_match_ref
from repro.models import LM as RefLM
from repro_torch import configs
from repro_torch.convert import lm_from_jax_params
from repro_torch.launch.serve import serve_session
from helpers_dist import elastic_rank, load_example, load_ranks, run_ranks

ROOT = Path(__file__).resolve().parents[1]
# the gate of test_torch_train.py's reference comparison of train_loop
TRAIN_TOL = 1e-4
DNA_SYMBOLS = 2 ** 14
# the surrogates' trees in the host-only examples' cases (150 by default):
# the reference's scalar SAML chain walks them one row at a time
SURROGATE_TREES = 20


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One thread while these tests run (the spawned ranks have one
    each; under pytest-xdist the workers share the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def lines(capsys, fn, *args, **kw):
    capsys.readouterr()
    out = fn(*args, **kw)
    return capsys.readouterr().out.splitlines(), out


def fewer_trees(monkeypatch):
    """Both packages' surrogates cut the same way, to ``SURROGATE_TREES``
    trees a model."""
    for core in (ref_core, port_core):
        monkeypatch.setattr(core, "fit_emil_surrogates", functools.partial(
            core.fit_emil_surrogates, n_estimators=SURROGATE_TREES))


def test_quickstart_prints_the_references_lines(capsys, monkeypatch):
    fewer_trees(monkeypatch)
    want, _ = lines(capsys, load_example("quickstart").main)
    got, _ = lines(capsys, load_example("torch_quickstart").main)
    assert got == want
    assert len(got) == 10


def test_dna_autotune_simulated_prints_the_references_lines(capsys,
                                                            monkeypatch):
    fewer_trees(monkeypatch)
    for core in (ref_core, port_core):
        monkeypatch.setattr(core, "DATASETS_GB",
                            {"cat": core.DATASETS_GB["cat"]})
    want, _ = lines(capsys, load_example("dna_autotune").simulated)
    got, _ = lines(capsys, load_example("torch_dna_autotune").main, [])
    assert got == want
    assert any(line.startswith("cat (2.43 GB): EM best") for line in got)


def test_dna_autotune_real_counts_are_exact(capsys):
    twin = load_example("torch_dna_autotune")
    out = twin.real("cpu", n_symbols=DNA_SYMBOLS)
    em, sam, measured = out["em"], out["sam"], out["measurements"]
    assert em.n_experiments == len(twin.CHUNKS)
    assert sorted({m["chunk"] for m in measured}) == list(twin.CHUNKS)
    assert sam.n_experiments <= em.n_experiments
    want = int(fa_match_ref(jnp.asarray(out["text"].numpy()),
                            jnp.asarray(out["table"]),
                            jnp.asarray(out["accept"]))[0])
    assert want > 0
    assert all(m["count"] == want for m in measured), measured
    printed = capsys.readouterr().out
    assert f"({em.n_experiments} measurements)" in printed


def test_train_lm_tiny_prints_the_references_lines_and_its_losses(
        capsys, monkeypatch, tmp_path):
    ref, twin = load_example("train_lm"), load_example("torch_train_lm")
    steps = 10
    # float32 compute on both sides, where TRAIN_TOL is the gate
    rcfg = dataclasses.replace(ref_configs.get("qwen2.5-3b").smoke(),
                               compute_dtype="float32")
    cfg = dataclasses.replace(configs.get("qwen2.5-3b").smoke(),
                              compute_dtype="float32")
    monkeypatch.setitem(ref.PRESETS["tiny"], "cfg", lambda: rcfg)
    monkeypatch.setitem(twin.PRESETS["tiny"], "cfg", lambda: cfg)
    runs = []

    def recorded(*a, **kw):
        runs.append(real_loop(*a, **kw))
        return runs[-1]

    real_loop = ref.train_loop
    monkeypatch.setattr(ref, "train_loop", recorded)
    argv = ["--preset", "tiny", "--steps", str(steps)]
    monkeypatch.setattr("sys.argv", ["train_lm.py", *argv, "--ckpt-dir",
                                     str(tmp_path / "ref")])
    want, _ = lines(capsys, ref.main)
    model = lm_from_jax_params(jax.tree.map(
        np.asarray, RefLM(rcfg).init(jax.random.PRNGKey(0))), cfg, "cpu")
    got, out = lines(capsys, twin.main, [*argv, "--ckpt-dir",
                                         str(tmp_path / "port"),
                                         "--device", "cpu"], model=model)
    # the example's own lines (the reference's logger also prints each
    # 10th step's line to stdout; the port's train_loop logs it through
    # ``logging``, which the twin's CLI sends to stderr)
    want = [line for line in want if line.startswith(("model:", "loss:"))]
    assert len(got) == len(want) == 2, (want, got)
    assert got[0] == want[0] and got[0].startswith("model: qwen2.5-3b-smoke")
    form = re.compile(r"loss: (\d+\.\d{4}) -> (\d+\.\d{4}) over (\d+) steps$")
    assert form.match(want[1]) and form.match(got[1]), (want, got)
    assert form.match(got[1]).group(3) == str(steps)
    np.testing.assert_allclose(out["losses"], runs[0]["losses"],
                               atol=TRAIN_TOL, rtol=TRAIN_TOL)


def test_train_lm_tiny_on_the_cpu_from_the_seed(capsys, tmp_path):
    twin = load_example("torch_train_lm")
    got, out = lines(capsys, twin.main, ["--steps", "3", "--device", "cpu",
                                         "--ckpt-dir", str(tmp_path)])
    assert got[0] == "model: qwen2.5-3b-smoke  params=0.4M"
    assert got[1].endswith("over 3 steps")
    # the checkpoint directory keeps its checkpoints, as the reference's
    # does: a longer run resumes where this one ended
    again, out2 = lines(capsys, twin.main, ["--steps", "5", "--device",
                                            "cpu", "--ckpt-dir",
                                            str(tmp_path)])
    assert out2["resumed_from"] == 3 and len(out2["losses"]) == 2
    assert again[1].endswith("over 2 steps (resumed from step 3)")


def test_serve_lm_gives_the_sessions_tokens(capsys):
    twin = load_example("torch_serve_lm")
    kw = dict(batch=2, prompt_len=8, gen=4, seed=0)
    out = twin.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                     "--gen", "4"])
    want = serve_session(configs.get("qwen2.5-3b").smoke(), device="cpu",
                         **kw)["generated"]
    np.testing.assert_array_equal(out["generated"], want)


def test_elastic_restart_on_two_ranks(tmp_path):
    run_ranks(elastic_rank, 2, tmp_path, shape=(2,), axes=("data",),
              args=(str(tmp_path),), timeout=120)
    ranks = load_ranks(tmp_path, 2)
    for r in ranks:
        assert r["attempts"] == 2 and r["resumed_from"] == 4
    r0, r1 = ranks
    # phase 1 ends with the uninterrupted run's parameters at step 12
    assert set(r0["phase1_12"]) == set(r0["want12"])
    for name, p in r0["want12"].items():
        assert torch.equal(r0["phase1_12"][name], p), name
    # phase 2: rank 0 alone resumes at 12; rank 1 takes no part
    assert r0["phase2"]["resumed_from"] == 12
    np.testing.assert_allclose(r0["phase2"]["losses"], r0["whole"][12:],
                               rtol=2e-4, atol=2e-4)
    assert r1["phase2"]["losses"] == [] and \
        r1["phase2"]["resumed_from"] is None


def port_table() -> dict[str, str]:
    """``docs/port.md``'s module table: reference module -> its row."""
    rows = {}
    for line in (ROOT / "docs" / "port.md").read_text().splitlines():
        m = re.match(r"\|\s*`(src/repro/[^`]+\.py)`\s*\|(.*)\|\s*$", line)
        if m:
            rows[m.group(1)] = m.group(2)
    return rows


def test_port_doc_names_every_reference_module():
    table = port_table()
    modules = sorted(str(p.relative_to(ROOT)) for p in
                     (ROOT / "src" / "repro").rglob("*.py"))
    assert modules and not [m for m in modules if m not in table]
    # each row names its twin in the port, or says why it has none
    for name, row in table.items():
        twins = re.findall(r"`(src/repro_torch/[^`]+\.py)`", row)
        assert twins or "no twin" in row, name
        for twin in twins:
            assert (ROOT / twin).exists(), (name, twin)
