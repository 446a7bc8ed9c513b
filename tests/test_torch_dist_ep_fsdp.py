"""Expert parallelism, the hybrid family and FSDP across a change of mesh,
over CPU ranks (the port's A6b).

* Qwen2-MoE smoke with its 8 experts split over the model axis ((1, 4),
  and (2, 2) with FSDP over data) and over the data axis (the rows of the
  data ranks gathered, the combine scattered back); Jamba's first 5
  layers (mamba layers replicated, ``mamba_tp=False``) on (1, 4) and
  (2, 2):
  every gradient leaf against the reference's, each rank's stored blocks
  against the reference's leaf sliced by its own ``param_specs``
  (``test_torch_dist_tp``'s checks);
* the twin of the reference's ``test_elastic_remesh_restore_continues_
  identically`` scaled to 4 -> 2 ranks with FSDP over data (int8 moments
  whose quantization blocks straddle ranks: ``test_torch_dist_a6c``).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from repro_torch import configs
from helpers_dist import load_ranks, run_ranks, train_rank
from test_torch_dist_tp import (  # noqa: F401 (one_thread: autouse)
    LAYOUTS, check_blocks, check_gradients, one_thread)

LAYOUTS["data2_model2_experts_data"] = ((2, 2), dict(
    model_axes=("model",), expert_axes=("data",)))
CASES = [("qwen2-moe-a2.7b", "model4_experts"),
         ("qwen2-moe-a2.7b", "data2_model2_fsdp_experts"),
         ("qwen2-moe-a2.7b", "data2_model2_experts_data"),
         ("jamba-v0.1-52b", "model4"),
         ("jamba-v0.1-52b", "data2_model2_fsdp")]


@pytest.mark.parametrize("arch, layout", CASES)
def test_sharded_gradients_match_reference(arch, layout, tmp_path_factory):
    check_gradients(arch, layout, tmp_path_factory, CASES)


@pytest.mark.parametrize("arch, layout", CASES)
def test_stored_blocks_are_reference_leaves_sliced(arch, layout,
                                                   tmp_path_factory):
    check_blocks(arch, layout, tmp_path_factory, CASES)


# -- elastic remesh -----------------------------------------------------------

CFG = configs.get("qwen2.5-3b").smoke()
RUN = dict(batch=8, seq_len=32)
FSDP = dict(data_axes=("data",), model_axes=(), fsdp_axes=("data",),
            remat=False)


def ranks_train(tmp_path, world, steps, **kw):
    tmp_path.mkdir()
    run_ranks(train_rank, world, tmp_path, shape=(world,), axes=("data",),
              args=(CFG, dict(steps_total=steps, **RUN, **kw), FSDP,
                    str(tmp_path)), timeout=90)
    return load_ranks(tmp_path, world)


def test_elastic_remesh_restore_continues_identically(tmp_path):
    """8 steps on 4 ranks, checkpointed at 4 and 8 (whole leaves, gathered);
    the step-4 checkpoint resumed on 2 ranks (each slices its blocks of the
    new mesh) to step 8: the losses of the 4-rank run's last 4 steps."""
    ckpt = tmp_path / "ckpt"
    straight = ranks_train(tmp_path / "a", 4, 8, ckpt_dir=str(ckpt),
                           ckpt_every=4)
    assert straight[0]["resumed_from"] is None
    shutil.rmtree(ckpt / "step_000000008")      # resume from step 4
    resumed = ranks_train(tmp_path / "b", 2, 8, ckpt_dir=str(ckpt),
                          ckpt_every=100)
    for r in resumed:
        assert r["resumed_from"] == 4
        np.testing.assert_allclose(r["losses"], straight[0]["losses"][4:],
                                   rtol=2e-4, atol=2e-4)
