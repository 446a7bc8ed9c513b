"""Mesh-rules API: install rules, query them, constrain intermediates.

Code annotates intermediates with *logical* axis names::

    x = constrain(x, "batch", "seq", None)

and the launch layer installs a rules table around the region that
should carry a layout::

    with use_rules(rules):
        out = step(batch)

``constrain`` resolves each logical name through the active table into
a per-dimension placement and hands it to the table's ``place``.  With
no rules installed (one card, plain tests) every call is the identity,
so unsharded paths never pay for the subsystem.  Dimensions whose extent
the mapped axes do not divide are left unplaced rather than erroring —
the rules are hints, not hard partitioning.

A rules table is any object with ``spec_dim(name, extent) -> axis | None``
and ``place(x, dims) -> x``: the reference's ``MeshRules`` (a logical
name -> mesh axes table over a JAX mesh) is not ported yet, so this
module holds the rule stack and the resolution, and the table decides
what a placement means for a tensor.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

__all__ = ["constrain", "constrain_leading", "current_rules", "use_rules"]

_STATE = threading.local()


def _stack() -> list:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def current_rules() -> Any | None:
    """The innermost installed rules table, or None when unsharded."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_rules(rules: Any | None):
    """Install ``rules`` for the dynamic extent of the block.

    ``None`` is accepted and pushes an explicit "no rules" scope — useful
    to locally disable placement inside a ruled region.
    """
    stack = _stack()
    stack.append(rules)
    try:
        yield rules
    finally:
        stack.pop()


def constrain(x: Any, *names: str | None) -> Any:
    """Place ``x`` as the active rules place ``names``.

    One logical name (or None) per tensor dimension.  No-op when no rules
    are installed, when the rank does not match, or when no dimension
    maps to an axis.
    """
    rules = current_rules()
    if rules is None:
        return x
    shape = getattr(x, "shape", None)
    if shape is None or len(shape) != len(names):
        return x
    dims = [rules.spec_dim(name, extent)
            for extent, name in zip(shape, names)]
    if all(d is None for d in dims):
        return x
    return rules.place(x, tuple(dims))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def constrain_leading(tree: Any, name: str = "batch") -> Any:
    """Constrain dimension 0 of every tensor leaf to logical axis ``name``.

    The chunked scheduler (``repro_torch.runtime.scheduler``) annotates
    each dispatched chunk this way: chunks are row slices of a batch (a
    dict of tensors), so only the leading dimension carries the
    data-parallel layout.  Like ``constrain`` this is the identity when
    no rules are installed.
    """
    if current_rules() is None:
        return tree

    def leaf(x):
        ndim = getattr(x, "ndim", None)
        if not ndim:            # scalars and non-tensors pass through
            return x
        return constrain(x, name, *([None] * (ndim - 1)))

    return _tree_map(leaf, tree)
