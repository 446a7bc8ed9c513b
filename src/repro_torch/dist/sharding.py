"""Mesh-rules sharding configuration.

``ShardingConfig`` is the single declarative description of how one
workload is distributed over a mesh: which mesh axes carry data
parallelism, tensor (model) parallelism, FSDP parameter sharding, expert
parallelism, and how decode KV caches are laid out.  ``rules(mesh)``
compiles it into a :class:`MeshRules` table mapping the *logical* axis
names the model code uses (``"batch"``, ``"heads"``, ``"ff"``,
``"vocab"``, ``"expert"``, ``"kv_seq"``, ...) onto mesh axes.

The ``*_specs`` helpers derive, for every leaf of a shape tree (anything
with a ``.shape``: tensors, ``torch.Size`` wrappers), a tuple with one
entry per dimension: ``None``, an axis name, or a tuple of axes — the
content of the reference's ``PartitionSpec``.  Every placement is
divisibility-checked against the leaf's shape and falls back to
replication for that dimension when the shard count does not divide it —
a config is never invalid, only less sharded.  They read only axis names
and sizes, so a spec is derived for the production (16, 16) or
(2, 16, 16) mesh with no processes (``launch.mesh.make_production_mesh``).

The port's trees are its own: per-layer parameters by name (no leading
scan-group axis), and per-layer decode caches, 4-D ``(B, S, KV, hd)``
where the reference stacks 5-D ``(G, B, S, KV, hd)`` leaves.  A port spec
is the reference's with its leading ``None`` dropped.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Mapping

from .ranks import axis_sizes

__all__ = ["ShardingConfig", "MeshRules", "param_specs", "opt_specs",
           "batch_specs", "cache_specs"]

Axes = tuple[str, ...]


@dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh-axes table bound to one mesh.

    ``rules["batch"]`` etc. are tuples of mesh axis names (possibly
    empty).  The table is what ``use_rules`` installs and what
    ``constrain``/``current_rules`` read back; model code never sees the
    ShardingConfig itself.
    """

    mesh: Any
    rules: Mapping[str, Axes] = field(default_factory=dict)

    def axes(self, name: str | None) -> Axes:
        if name is None:
            return ()
        return tuple(self.rules.get(name, ()))

    def axes_size(self, axes: Axes) -> int:
        return _axes_size(self.mesh, axes)

    def spec_dim(self, name: str | None, extent: int):
        """The spec entry for one dimension of extent ``extent``."""
        return _dim_entry(self.mesh, self.axes(name), extent)

    def place(self, x, dims):
        """In the port every tensor is already its rank's local part (the
        layouts are realised where data enters a rank), so placing is the
        identity; ``constrain`` still resolves ``dims``."""
        del dims
        return x


def _names(mesh) -> tuple[str, ...]:
    return tuple(axis_sizes(mesh))


def _present(axes, mesh) -> Axes:
    names = _names(mesh)
    return tuple(a for a in axes if a in names)


@dataclass(frozen=True)
class ShardingConfig:
    """Declarative distribution policy for one workload.

    data_axes / model_axes / fsdp_axes / expert_axes name mesh axes (they
    are filtered against the mesh actually in use, so one config works on
    both a host mesh of ranks and the 256-chip production mesh).
    ``kv_shard`` picks the decode-cache layout:

      * ``"heads"``     — KV heads over the model axes (default)
      * ``"batch_seq"`` — batch over data axes, cache sequence over model
                          axes (sequence-sharded decode path)
      * ``"seq"``       — cache sequence over the data axes, batch
                          replicated (single-sequence long-context decode)
      * ``"none"``      — batch over data axes only

    ``grad_compression`` ("none" | "int8" | "topk") switches the train
    step to error-feedback compressed gradients (see
    ``repro_torch.dist.compression``).
    """

    data_axes: Axes = ("data",)
    model_axes: Axes = ("model",)
    fsdp_axes: Axes = ()
    expert_axes: Axes = ()
    kv_shard: str = "heads"          # "heads" | "batch_seq" | "seq" | "none"
    seq_parallel: bool = False
    microbatches: int = 1
    remat: bool = False
    remat_policy: str = "full"       # "full" | "save_dots"
    mamba_tp: bool = False
    moments_dtype: str = "float32"
    grad_compression: str = "none"   # "none" | "int8" | "topk"

    # -- derived ---------------------------------------------------------------
    def batch_axes(self, mesh) -> Axes:
        """Mesh axes carrying the batch dimension (pod axis included)."""
        if self.kv_shard == "seq":
            return ()                 # single-sequence decode: replicate batch
        pod = ("pod",) if "pod" in _names(mesh) else ()
        return pod + _present(self.data_axes, mesh)

    def kv_seq_axes(self, mesh) -> Axes:
        if self.kv_shard == "seq":
            pod = ("pod",) if "pod" in _names(mesh) else ()
            return pod + _present(self.data_axes, mesh)
        if self.kv_shard == "batch_seq":
            return _present(self.model_axes, mesh)
        return ()

    def rules(self, mesh) -> MeshRules:
        """Compile this config into the logical-axis table for ``mesh``."""
        model = _present(self.model_axes, mesh)
        return MeshRules(mesh=mesh, rules={
            "batch": self.batch_axes(mesh),
            "seq": model if self.seq_parallel else (),
            "heads": model,
            "kv_heads": model if self.kv_shard == "heads" else (),
            "ff": model,
            "mamba_ff": model if self.mamba_tp else (),
            "vocab": model,
            "expert": _present(self.expert_axes, mesh),
            "kv_seq": self.kv_seq_axes(mesh),
        })


# -- spec derivation -------------------------------------------------------------

def _axes_size(mesh, axes: Axes) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes) if axes else 1


def _dim_entry(mesh, axes: Axes, extent: int):
    """Spec entry for one dimension: ``axes`` when they divide ``extent``,
    else None (the subsystem-wide replication fallback)."""
    size = _axes_size(mesh, axes)
    if not axes or size <= 1 or extent < size or extent % size:
        return None
    return axes if len(axes) > 1 else axes[0]


def _is_shape_leaf(x: Any) -> bool:
    return hasattr(x, "shape")


def _map(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over dicts, lists and tuples of shape leaves;
    ``path`` holds the keys (dict keys, list indices) from the root."""
    if _is_shape_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    raise TypeError(f"not a shape leaf or container: {type(tree).__name__}")


def _weight_spec(shape: tuple[int, ...], mesh,
                 scfg: ShardingConfig) -> tuple:
    """2D weight sharding: one dim over the model axes (TP), another over
    the FSDP axes — largest divisible dims win, replicate otherwise."""
    spec: list = [None] * len(shape)
    used: set[str] = set()
    for axes in (_present(scfg.model_axes, mesh),
                 _present(scfg.fsdp_axes, mesh)):
        # a mesh axis may appear in both roles (e.g. fsdp over the model
        # axes); it can shard only one dim of any given leaf
        axes = tuple(a for a in axes if a not in used)
        size = _axes_size(mesh, axes)
        if size <= 1:
            continue
        cands = sorted(
            (i for i in range(len(shape))
             if spec[i] is None and shape[i] >= size and shape[i] % size == 0),
            key=lambda i: (-shape[i], i))
        if cands:
            spec[cands[0]] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
    return tuple(spec)


def param_specs(shapes: Any, mesh, scfg: ShardingConfig) -> Any:
    """Spec tree for a parameter (or parameter-shaped) tree."""
    return _map(lambda _, l: _weight_spec(tuple(l.shape), mesh, scfg), shapes)


def opt_specs(opt_shapes: Any, param_shapes: Any, mesh,
              scfg: ShardingConfig) -> Any:
    """Spec tree for AdamW state ({m, v, count}).

    Moment leaves (float32 mirrors, or int8 {q, scale, minv} blocks whose
    last axis is block-padded) get the same 2D weight treatment as the
    parameters they shadow; divisibility fallback handles the padding.
    ``param_shapes`` is accepted for API symmetry with the callers.
    """
    del param_shapes
    return _map(lambda _, l: _weight_spec(tuple(l.shape), mesh, scfg),
                opt_shapes)


def batch_specs(shapes: Any, mesh, scfg: ShardingConfig) -> Any:
    """Spec tree for a host data batch: leading dim over the batch axes
    (when divisible), everything else replicated."""
    batch = scfg.batch_axes(mesh)

    def leaf(_, l) -> tuple:
        shape = tuple(l.shape)
        if not shape:
            return ()
        return (_dim_entry(mesh, batch, shape[0]),) + (None,) * (len(shape)
                                                                - 1)

    return _map(leaf, shapes)


def cache_specs(shapes: Any, mesh, scfg: ShardingConfig) -> Any:
    """Spec tree for the port's per-layer decode state.

    Attention KV caches — the 4-D ``(B, S, KV, hd)`` leaves keyed
    ``"k"``/``"v"`` — are laid out per ``kv_shard``; every other state
    leaf (SSM / RWKV / conv, including the 4-D ``"wkv"`` state) shards
    batch only.  Equal to the reference's spec of the stacked leaf with
    its leading group entry dropped.
    """
    batch = scfg.batch_axes(mesh)
    kv_seq = scfg.kv_seq_axes(mesh)
    kv_heads = (_present(scfg.model_axes, mesh)
                if scfg.kv_shard == "heads" else ())

    def leaf(path, l) -> tuple:
        shape = tuple(l.shape)
        key = path[-1] if path else None
        if len(shape) == 4 and key in ("k", "v"):
            return (_dim_entry(mesh, batch, shape[0]),
                    _dim_entry(mesh, kv_seq, shape[1]),
                    _dim_entry(mesh, kv_heads, shape[2]), None)
        if shape:
            return (_dim_entry(mesh, batch, shape[0]),) + (None,) * (
                len(shape) - 1)
        return ()

    return _map(leaf, shapes)
