"""The paper's Fig. 2 and Tables 2, 4 and 5 through the port, row for row
against the JAX package's ``benchmarks/paper_tables.py``.

``scripts/torch_paper_tables.py`` is the port's twin of that benchmark:
the platform model, the surrogate fit and the scalar search engines are
numpy in both packages, so every row must be equal, not close.  Tables
6-9 (the 2000-iteration SAML chains) are held for one dataset in
``test_torch_paper_tables_saml.py`` and ``test_torch_paper_tables_speedup.py``.
"""

import importlib.util

import pytest

from helpers import REPO

from repro.core import EmilPlatformModel as RefModel
from repro_torch.core import EmilPlatformModel


def load(name: str, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tables():
    return (load("torch_paper_tables", REPO / "scripts/torch_paper_tables.py"),
            load("ref_paper_tables", REPO / "benchmarks/paper_tables.py"))


@pytest.mark.parametrize("name", ["fig2_motivation",
                                  "tables_4_5_prediction_accuracy",
                                  "table_2_strategy_costs"])
def test_rows_equal_the_reference(tables, name):
    port, ref = tables
    rows, derived = getattr(port, name)(EmilPlatformModel())
    want_rows, want_derived = getattr(ref, name)(RefModel())
    assert len(rows) == len(want_rows) > 0
    for got, want in zip(rows, want_rows):
        assert got == want
    assert derived == want_derived


def test_script_writes_every_table(tmp_path, tables):
    port, _ = tables
    out = tmp_path / "paper.json"
    assert port.main(["--tables", "fig2", "tables45", "--out",
                      str(out)]) == 0
    import json
    body = json.loads(out.read_text())
    assert set(body) == {"fig2", "tables45"}
    assert len(body["fig2"]["rows"]) == 33
    assert "n_experiments=7200" in body["tables45"]["derived"]
