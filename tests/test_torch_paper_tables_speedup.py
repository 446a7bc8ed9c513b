"""The paper's Tables 8 and 9 (speedups over host-only and device-only) through the port, row for row against the JAX
package's ``benchmarks/paper_tables.py``, for one dataset (``cat``).

Each table runs the scalar SAML chain for 2000 iterations a dataset on
surrogates fit to all four genomes; the reference's chain takes about a
minute a dataset here, so the test takes one (the port's rows for the
other three come from the same code).  The reference's function loops
over its module's ``DATASETS_GB``: the test hands it a mapping whose
``items()`` yield only ``cat`` while its ``values()`` stay all four, so
the reference still fits on every genome, as the port does.
"""

import importlib.util

from helpers import REPO

from repro.core import EmilPlatformModel as RefModel
from repro_torch.core import EmilPlatformModel


class OnlyCat(dict):
    """All four genomes for the fit, ``cat`` alone for the loop."""

    def items(self):
        return [("cat", self["cat"])]


def load(name: str, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tables_8_9_speedup_rows_equal_the_reference_for_cat():
    port = load("torch_paper_tables", REPO / "scripts/torch_paper_tables.py")
    ref = load("ref_paper_tables", REPO / "benchmarks/paper_tables.py")
    ref.DATASETS_GB = OnlyCat(ref.DATASETS_GB)
    rows, derived = port.tables_8_9_speedup(EmilPlatformModel(), datasets=["cat"])
    want_rows, want_derived = ref.tables_8_9_speedup(RefModel())
    assert len(rows) == len(want_rows) == 9
    for got, want in zip(rows, want_rows):
        assert got == want
    assert derived == want_derived
