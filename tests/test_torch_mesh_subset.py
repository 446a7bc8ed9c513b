"""A mesh over part of the ranks (``launch.mesh.make_host_mesh(n)`` with
``n`` below the group's size), the counterpart of the reference's
``make_host_mesh(n)`` over its first ``n`` devices: every rank of the
group calls it, the first ``n`` ranks train and serve on it, and the
others (``mesh.member`` False) return at once from ``train_loop`` and
``serve_session`` without joining a collective.

Two CPU gloo ranks, spawned once for the file: 8 steps of the Qwen2.5-3B
smoke config on the two-rank mesh (FSDP over data, checkpoints at 4 and
8), then rank 0 resumes to step 12 on ``make_host_mesh(1)`` and serves on
it; the losses are held to an uninterrupted two-rank run within the 2e-4
of ``test_torch_dist_train.py::test_elastic_resume_on_one_rank_continues``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch.serve import serve_session
from helpers_dist import load_ranks, mesh_subset_rank, run_ranks

CFG = configs.get("qwen2.5-3b").smoke()
RUN = dict(batch=8, seq_len=32)
FSDP = dict(data_axes=("data",), model_axes=(), fsdp_axes=("data",),
            remat=False)
SERVE = dict(batch=2, prompt_len=8, gen=4, seed=0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("subset")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        run_ranks(mesh_subset_rank, 2, out, shape=(2,), axes=("data",),
                  args=(CFG, RUN, FSDP, SERVE, str(out)), timeout=120)
    finally:
        torch.set_num_threads(before)
    return load_ranks(out, 2)


def test_first_rank_resumes_on_the_sub_mesh(ranks):
    r0 = ranks[0]
    assert r0["member"] and r0["sub_size"] == 1
    assert len(r0["first"]) == 8
    assert r0["resumed"]["resumed_from"] == 8
    assert r0["resumed_state"]
    np.testing.assert_allclose(r0["resumed"]["losses"], r0["whole"][8:],
                               rtol=2e-4, atol=2e-4)


def test_rank_outside_the_sub_mesh_neither_raises_nor_trains(ranks):
    r1 = ranks[1]
    assert not r1["member"]
    assert r1["resumed"] == {"losses": [], "resumed_from": None,
                             "final_loss": None}
    assert not r1["resumed_state"]
    assert r1["generated"] is None
    # the two-rank runs before the shrink ran on both ranks alike
    np.testing.assert_array_equal(r1["whole"], ranks[0]["whole"])


def test_a_mesh_larger_than_the_group_raises(ranks):
    for r in ranks:
        assert r["too_large"] is not None and "needs 3 ranks" in \
            r["too_large"], r["too_large"]


def test_serving_on_the_sub_mesh_gives_one_process_tokens(ranks):
    want = serve_session(CFG, device="cpu", **SERVE)["generated"]
    np.testing.assert_array_equal(ranks[0]["generated"], want)
