"""State carried across from the JAX reference package.

There are no model weights on the tuning/matching path; what the two
packages share is (a) a motif DFA, (b) a fitted BDTR surrogate and (c) a
``TuningStore`` file.  The store needs no converter: both packages write
the same checksummed JSON envelope, so a file written by one loads in
the other (keys differ by device topology by design).  The other two are
handed over as numpy arrays:
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from .core.bdtr import BoostedTreesRegressor, Tree

__all__ = ["bdtr_from_arrays", "dfa_to_device"]


def dfa_to_device(table, accept, device) -> tuple[torch.Tensor, torch.Tensor]:
    """A DFA as ``build_motif_dfa`` of either package returns it — table
    ``(S, 4)`` int32 and accept ``(S,)`` bool, numpy arrays or tensors —
    as contiguous int32 tensors on ``device``."""
    dev = torch.device(device)
    table = torch.as_tensor(table).to(device=dev, dtype=torch.int32)
    accept = torch.as_tensor(accept).to(device=dev, dtype=torch.int32)
    return table.contiguous(), accept.contiguous()


def bdtr_from_arrays(trees: Sequence[Mapping[str, Any]], base: float,
                     learning_rate: float, *, max_depth: int | None = None,
                     **params: Any) -> BoostedTreesRegressor:
    """Rebuild a fitted ensemble from per-tree numpy arrays.

    ``trees`` holds one mapping per tree with the packed node arrays
    ``feature``, ``threshold``, ``left``, ``right``, ``value`` (and
    optionally ``depth``), exactly the fields of the reference's
    ``repro.core.bdtr.Tree``; ``base`` and ``learning_rate`` are its
    ``base_`` and ``learning_rate``.  The result predicts the same
    numbers as the ensemble the arrays came from.  ``params`` are
    further constructor fields (``min_samples_leaf``, ``tree_method``,
    ...) for a later ``fit_more``.
    """
    out = []
    for t in trees:
        depth = t.get("depth", max_depth)
        if depth is None:
            raise ValueError("tree depth missing: pass max_depth=")
        out.append(Tree(
            feature=np.asarray(t["feature"], dtype=np.int32),
            threshold=np.asarray(t["threshold"], dtype=np.float64),
            left=np.asarray(t["left"], dtype=np.int32),
            right=np.asarray(t["right"], dtype=np.int32),
            value=np.asarray(t["value"], dtype=np.float64),
            depth=int(depth)))
    if max_depth is None:
        max_depth = max((t.depth for t in out), default=4)
    model = BoostedTreesRegressor(n_estimators=len(out),
                                  learning_rate=float(learning_rate),
                                  max_depth=int(max_depth), **params)
    model.base_ = float(base)
    model.trees_ = out
    return model
