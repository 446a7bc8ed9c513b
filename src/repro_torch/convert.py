"""State carried across from the JAX reference package.

What the two packages share is (a) a motif DFA, (b) a fitted BDTR
surrogate, (c) a ``TuningStore`` file, (d) a language model's weights and
(e) a training state (weights and AdamW moments).
The store needs no converter: both packages write the same checksummed
JSON envelope, so a file written by one loads in the other (keys differ by
device topology by design).  The others are handed over as numpy arrays:
``dfa_to_device``, ``bdtr_from_arrays``, ``lm_from_jax_params`` /
``encdec_from_jax_params`` and ``train_state_from_jax``.  Checkpoints are
not shared: the reference keys leaves by a JAX treedef, the port by name.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from . import resolve_device
from .core.bdtr import BoostedTreesRegressor, Tree

__all__ = ["bdtr_from_arrays", "dfa_to_device", "encdec_from_jax_params",
           "lm_from_jax_params", "train_state_from_jax"]


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


def _put(dst: Mapping[str, Any], src: Mapping[str, Any], where: str,
         stack: tuple[int, int] | None = None) -> None:
    """Copy the reference leaves ``src`` into the parameters ``dst`` (nested
    dicts alike); ``stack = (i, n)`` cuts entry ``i`` of a leading axis of
    ``n`` from every leaf.  Every leaf must be used and match its
    parameter's shape, or ``ValueError`` says which does not."""
    if set(dst) != set(src):
        raise ValueError(f"{where}: reference leaves {sorted(src)} vs "
                         f"port parameters {sorted(dst)}")
    for name, p in dst.items():
        if isinstance(src[name], Mapping):      # a nested dict (MoE shared)
            if isinstance(p, torch.nn.Parameter):
                raise ValueError(f"{where}.{name}: the reference has a "
                                 "dict where the port has a parameter")
            _put(p, src[name], f"{where}.{name}", stack)
            continue
        if not isinstance(p, torch.nn.Parameter):
            raise ValueError(f"{where}.{name}: the reference has a leaf "
                             "where the port has a dict")
        arr = np.asarray(src[name], dtype=np.float32)
        if stack is not None:
            i, n = stack
            if arr.shape[:1] != (n,):
                raise ValueError(f"{where}.{name}: {arr.shape[:1]} on the "
                                 f"stacked axis, config has {n}")
            arr = arr[i]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{where}.{name}: shape {arr.shape} vs "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.tensor(arr))


def lm_from_jax_params(params: Mapping[str, Any], cfg, device=None):
    """The port's ``LM`` holding the reference's weights.

    ``params`` is the reference's parameter tree with numpy leaves (what
    ``jax.tree.map(np.asarray, LM(cfg).init(key))`` gives): nested dicts,
    the layers stacked on a leading scan-group axis under
    ``params["layers"]["slot<i>"]``.  Layer ``g * len(group_pattern) + i``
    of the port takes group ``g`` of slot ``i``, whatever its mixer (attn,
    mamba, rwkv) and channel (MLP, MoE with its nested ``shared`` expert,
    rwkv channel mix).  Every leaf must be used and match its parameter's
    shape, or ``ValueError`` says which does not.  Each parameter keeps
    its own dtype (a float32 leaf such as ``A_log`` stays float32 whatever
    ``param_dtype`` is).
    """
    from .models import LM

    dev = resolve_device(device)
    model = LM(cfg, device="meta").to_empty(device=dev)
    period = len(cfg.group_pattern)

    _put(model.embed, params["embed"], "embed")
    _put(model.final_norm, params["final_norm"], "final_norm")
    for i, layer in enumerate(model.layers):
        group, slot = divmod(i, period)
        src = params["layers"][f"slot{slot}"]
        if set(src) != set(layer):
            raise ValueError(f"layers.slot{slot}: {sorted(src)} vs "
                             f"{sorted(layer)}")
        for part, dst in layer.items():
            _put(dst, src[part], f"layers.slot{slot}.{part}",
                 (group, cfg.n_groups))
    return model


def encdec_from_jax_params(params: Mapping[str, Any], cfg, device=None):
    """The port's ``EncDec`` holding the reference's weights.

    ``params`` is the reference's ``EncDec(cfg).init(key)`` tree with numpy
    leaves: ``embed``, ``enc_norm``, ``final_norm``, and ``encoder`` /
    ``decoder``, each layer part's leaves stacked on a leading layer axis
    (``jax.vmap`` of the layer init).  Encoder layer ``i`` of the port
    takes entry ``i`` of ``params["encoder"]``, decoder layer ``i`` entry
    ``i`` of ``params["decoder"]``.  Every leaf must be used and match its
    parameter's shape, or ``ValueError`` says which does not.
    """
    from .models import EncDec

    dev = resolve_device(device)
    model = EncDec(cfg, device="meta").to_empty(device=dev)
    for part in ("embed", "enc_norm", "final_norm"):
        _put(getattr(model, part), params[part], part)
    for stack in ("encoder", "decoder"):
        layers = getattr(model, stack)
        src = params[stack]
        for i, layer in enumerate(layers):
            if set(src) != set(layer):
                raise ValueError(f"{stack}: {sorted(src)} vs {sorted(layer)}")
            for part, dst in layer.items():
                _put(dst, src[part], f"{stack}.{part}", (i, len(layers)))
    return model


def _reference_leaf(tree: Mapping[str, Any], name: str, cfg) -> Any:
    """The leaf of a reference tree shaped like its parameters (the
    parameters, or an AdamW moment tree) for the port's parameter
    ``name``: layer ``g * len(group_pattern) + i`` is group ``g`` of
    ``tree["layers"]["slot<i>"]``, and an encoder-decoder's ``encoder.<i>``
    / ``decoder.<i>`` entry ``i`` of ``tree["encoder"]`` /
    ``tree["decoder"]``.  An int8 moment's leaf is the dict of its codes
    and scales, each cut to the layer."""
    parts = name.split(".")
    index = None
    node = tree
    if parts[0] == "layers":
        index, slot = divmod(int(parts[1]), len(cfg.group_pattern))
        node, parts = tree["layers"][f"slot{slot}"], parts[2:]
    elif parts[0] in ("encoder", "decoder"):
        index = int(parts[1])
        node, parts = tree[parts[0]], parts[2:]
    for key in parts:
        node = node[key]
    if index is None:
        return node
    if isinstance(node, Mapping):
        return {k: np.asarray(v)[index] for k, v in node.items()}
    return np.asarray(node)[index]


def train_state_from_jax(state: Mapping[str, Any], cfg, device=None):
    """The port's ``(model, opt_state)`` holding the reference's training
    state ``{"params", "opt", "step"}`` with numpy leaves: an ``EncDec``
    for an encoder-decoder config, else an ``LM``.

    The moments are float32 arrays or, for int8 moments, the reference's
    ``{"q", "scale"[, "minv"]}`` dicts; each is keyed here by the port's
    parameter name, as ``repro_torch.optim.adamw.init_opt_state`` keys
    them.  With the same batch both packages then compute the same step.
    """
    dev = resolve_device(device)
    convert = encdec_from_jax_params if cfg.encdec else lm_from_jax_params
    model = convert(state["params"], cfg, dev)
    opt = {"m": {}, "v": {},
           "count": torch.tensor(int(np.asarray(state["opt"]["count"])),
                                 dtype=torch.int32)}

    def tensor(arr) -> torch.Tensor:
        return torch.from_numpy(np.array(arr)).to(dev)

    for name, p in model.named_parameters():
        for part in ("m", "v"):
            leaf = _reference_leaf(state["opt"][part], name, cfg)
            if isinstance(leaf, Mapping):
                opt[part][name] = {k: tensor(v) for k, v in leaf.items()}
                continue
            t = tensor(np.asarray(leaf, dtype=np.float32))
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"opt.{part}.{name}: shape "
                                 f"{tuple(t.shape)} vs {tuple(p.shape)}")
            opt[part][name] = t
    return model, opt
