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

import torch

from .api import current_rules
from .collectives import (all_gather, all_reduce, all_reduce_, gather_raw,
                          reduce_scatter, scatter_raw)
from .ranks import RankMesh, axis_sizes

__all__ = ["ComputeLayout", "LeafLayout", "MeshRules", "ParamLayout",
           "ShardingConfig", "Split", "Spread", "batch_specs", "block_slices",
           "cache_specs", "compute_layout", "gather_leaf", "opt_specs",
           "param_specs", "region", "shard_leaf", "unshard_leaf"]

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
        """This rank's block of the whole tensor ``x`` under ``dims`` (one
        spec entry a dimension) where the mesh is one of ranks and an
        entry spans more than one of them; otherwise ``x`` (a shape-only
        mesh's layouts are derived, never run)."""
        if not isinstance(self.mesh, RankMesh) or all(
                self.axes_size(_entry_axes(e)) <= 1 for e in dims):
            return x
        return shard_leaf(x, dims, self.mesh)


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


# -- blocks: storage ----------------------------------------------------------

def _entry_axes(entry) -> Axes:
    """A spec entry's axes: ``()``, ``(axis,)`` or the tuple itself."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_slices(shape, spec, mesh) -> tuple[slice, ...]:
    """The slices of this rank's block of a leaf of ``shape`` under
    ``spec`` (one entry a dimension), on a mesh of ranks."""
    out = []
    for extent, entry in zip(shape, spec):
        axes = _entry_axes(entry)
        n = _axes_size(mesh, axes)
        per = extent // n
        i = mesh.index(axes) if n > 1 else 0
        out.append(slice(i * per, (i + 1) * per))
    return tuple(out)


def shard_leaf(full, spec, mesh):
    """This rank's block of the whole leaf ``full`` (a tensor of its own,
    so the whole leaf can be freed)."""
    return full[block_slices(full.shape, spec, mesh)].clone()


def unshard_leaf(block, spec, mesh):
    """The whole leaf from the blocks of every rank (``shard_leaf``'s
    inverse): an all-gather along each sharded dimension."""
    x = block
    for dim, entry in enumerate(spec):
        if _axes_size(mesh, _entry_axes(entry)) > 1:
            x = gather_raw(x, mesh, _entry_axes(entry), dim)
    return x


# -- blocks: compute ----------------------------------------------------------

@dataclass(frozen=True)
class Split:
    """One logical axis over mesh ``axes``: ``n`` ranks, this one at
    ``index``."""

    axes: Axes = ()
    n: int = 1
    index: int = 0

    def range(self, extent: int) -> slice | None:
        """This rank's part of ``extent``, or ``None`` where the split
        does not divide it (the reference's replication fallback)."""
        if self.n <= 1 or extent < self.n or extent % self.n:
            return None
        per = extent // self.n
        return slice(self.index * per, (self.index + 1) * per)


def _split(mesh, axes: Axes) -> Split:
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    n = _axes_size(mesh, axes)
    return Split(axes, n, mesh.index(axes) if n > 1 else 0)


class ComputeLayout:
    """What this rank computes under a rules table over a mesh of ranks:
    its q heads, the kv heads they read, its ``ff`` columns, its vocab
    slice, its experts and its Mamba channels (``mamba_tp``), and whether
    the residual stream holds its rows of the sequence
    (``seq_parallel``).  Model code reads it at the reference's
    ``constrain`` sites through ``compute_layout()``."""

    def __init__(self, rules: MeshRules):
        mesh = rules.mesh
        self.mesh = mesh
        self.model = _split(mesh, rules.axes("heads"))
        self.ff_split = _split(mesh, rules.axes("ff"))
        self.vocab_split = _split(mesh, rules.axes("vocab"))
        self.expert = _split(mesh, rules.axes("expert"))
        self.mamba = _split(mesh, rules.axes("mamba_ff"))
        self.seq = _split(mesh, rules.axes("seq"))
        self.kv_sharded = bool(rules.axes("kv_heads"))
        self.batch_axes = tuple(a for a in rules.axes("batch")
                                if mesh.shape[a] > 1)

    @property
    def trivial(self) -> bool:
        """Nothing split but (maybe) the batch."""
        return max(self.model.n, self.ff_split.n, self.vocab_split.n,
                   self.expert.n, self.mamba.n, self.seq.n) <= 1

    # -- the parts this rank computes -----------------------------------------
    def heads(self, n_heads: int) -> slice | None:
        return self.model.range(n_heads)

    def head_channels(self, n_heads: int, head_dim: int) -> slice | None:
        """The channels of this rank's heads, ``head_dim`` a head (RWKV-6's
        r/k/v/g columns, its decay and group norm)."""
        h = self.heads(n_heads)
        return None if h is None else slice(h.start * head_dim,
                                            h.stop * head_dim)

    def mamba_channels(self, d_inner: int) -> slice | None:
        """This rank's Mamba channels under ``mamba_tp``."""
        return self.mamba.range(d_inner)

    def kv_heads(self, n_heads: int, n_kv: int) -> slice | None:
        """The kv heads this rank's q heads read (``None``: all)."""
        q = self.heads(n_heads)
        if q is None:
            return None
        rep = n_heads // n_kv
        return slice(q.start // rep, (q.stop - 1) // rep + 1)

    def kv_computed(self, n_heads: int, n_kv: int) -> slice | None:
        """The kv heads this rank projects and caches: those its q heads
        read under ``kv_shard="heads"``, all of them otherwise (the
        reference's replicated ``kv_heads``)."""
        return self.kv_heads(n_heads, n_kv) if self.kv_sharded else None

    def ff(self, d_ff: int) -> slice | None:
        return self.ff_split.range(d_ff)

    def vocab(self, vocab: int) -> slice | None:
        return self.vocab_split.range(vocab)

    def experts(self, n_experts: int) -> slice | None:
        return self.expert.range(n_experts)

    def seq_rows(self, t: int) -> slice | None:
        return self.seq.range(t)

    # -- the collectives at the constrain sites -------------------------------
    def reduce(self, y, partial: Axes = (), seq_dim: int | None = None):
        """Finish a sublayer's output: sum the ranks' contributions over
        ``partial`` axes; with ``seq_dim`` keep this rank's rows of it
        (``seq_parallel``: a reduce-scatter where the contributions are
        summed over the sequence's own axes, else a slice)."""
        partial = tuple(a for a in partial if self.mesh.shape[a] > 1)
        rows = None if seq_dim is None else self.seq_rows(y.shape[seq_dim])
        if rows is None:
            return all_reduce(y, self.mesh, partial) if partial else y
        if set(partial) == set(self.seq.axes):
            return reduce_scatter(y, self.mesh, self.seq.axes, seq_dim)
        if partial:
            y = all_reduce(y, self.mesh, partial)
        return y.narrow(seq_dim, rows.start, rows.stop - rows.start)

    def gather_seq(self, x, seq_dim: int, t: int):
        """The whole sequence (``t`` rows) from each rank's rows."""
        if self.seq_rows(t) is None:
            return x
        return all_gather(x, self.mesh, self.seq.axes, seq_dim)


def region(shape, dim: int | None = None, rng=None, split: Split = Split(),
           even: bool = True) -> tuple:
    """A leaf's compute region for ``leaf_layout``: the whole of every
    dimension of ``shape``, but ``rng`` (a slice, a tuple of slices, or
    ``None``: the whole) along ``dim``, this rank's part of ``split``
    (``even``: an even part of the extent, see ``leaf_layout``)."""
    out: list = [None] * len(shape)
    if rng is not None:
        out[dim] = (rng, split.axes, even)
    return tuple(out)


def compute_layout() -> ComputeLayout | None:
    """The active rules' ``ComputeLayout``, or ``None`` where nothing is
    split: no rules, a mesh with no ranks behind it, or every logical axis
    over one rank (the paths of one process run unchanged).  Data-parallel
    training installs no rules (``launch.steps``); a model sharded over
    ranks does (``LM.shard``), and with it the batch counts as split (the
    MoE aux loss reads it)."""
    rules = current_rules()
    if not isinstance(rules, MeshRules) or not isinstance(rules.mesh,
                                                           RankMesh):
        return None
    cached = rules.__dict__.get("_compute")
    if cached is None:
        cached = ComputeLayout(rules)
        object.__setattr__(rules, "_compute", cached)
    return None if cached.trivial and not cached.batch_axes else cached


# -- a parameter leaf between its storage block and its compute block ---------

@dataclass(frozen=True)
class LeafLayout:
    """One parameter leaf: ``spec`` (storage, ``param_specs``), the rank's
    storage ``block`` and compute ``region`` (slices of the whole leaf),
    the ``steps`` that take the block to the region — ``("gather", dim,
    axes)`` (an all-gather along ``dim``) and ``("cut", dim, slice)`` —
    and the axes over which its gradient is also summed (``also_sum``).
    A dimension whose compute split is its storage split (the same axes)
    is never gathered: the rank's block along it is its compute range.  A
    dimension is cut to the rank's range before a gather wherever every
    rank of that gather (and of ``also_sum``) computes on the same range
    of it, so less crosses the ranks (Qwen2-MoE's experts: gathered whole
    over the model axis, which splits them, then cut to the rank's
    experts, then gathered over FSDP's data axis)."""

    shape: tuple
    spec: tuple
    block: tuple
    region: tuple
    steps: tuple
    also_sum: Axes

    @property
    def storage_axes(self) -> Axes:
        return tuple(a for e in self.spec for a in _entry_axes(e))


def leaf_layout(shape, spec, region, mesh, batch_axes: Axes) -> LeafLayout:
    """``region`` holds, for each dimension, ``None`` (the whole extent)
    or ``(range, axes, even)``: the compute range, the mesh axes whose
    coordinates it depends on, and whether it is this rank's part of an
    even split of the extent over them (the kv heads a rank's q heads read
    depend on the model axes without being such a part).  A range is a
    slice, or a tuple of slices taken in turn (Mamba's ``in_proj`` under
    ``mamba_tp``: the rank's channels of its ``xs`` half, then the same
    channels of its ``z`` half; never ``even``: a storage split is
    contiguous)."""
    block = block_slices(shape, spec, mesh)
    reg, deps, aligned, gathers = [], [], [], []
    aligned_dims = set()
    for dim, (extent, entry, r) in enumerate(zip(shape, spec, region)):
        axes = tuple(a for a in _entry_axes(entry) if mesh.shape[a] > 1)
        rng, raxes, even = (slice(0, extent), (), True) if r is None else r
        raxes = tuple(a for a in raxes if mesh.shape[a] > 1)
        reg.append(rng)
        deps.append(set(raxes))
        if axes and even and raxes == axes:
            aligned.extend(axes)
            aligned_dims.add(dim)
        elif axes:
            gathers.append((dim, axes))
    gathered = {a for _, axes in gathers for a in axes}
    also_sum = tuple(a for a in mesh.axis_names
                     if mesh.shape[a] > 1 and a not in batch_axes
                     and a not in aligned and a not in gathered)
    # gathers over axes some range depends on first: after them the
    # ranks of the others share those ranges
    dep_axes = set().union(*deps)
    gathers.sort(key=lambda g: not set(g[1]) & dep_axes)
    cuts = [d for d, r in enumerate(region)
            if r is not None and d not in aligned_dims]
    steps: list = []
    done: set = set()
    for j, (dim, axes) in enumerate(gathers):
        later = {a for _, ax in gathers[j:] for a in ax} | set(also_sum)
        pending = {g[0] for g in gathers[j:]}
        for d in cuts:
            if d not in done and d not in pending and not deps[d] & later:
                steps.append(("cut", d, reg[d]))
                done.add(d)
        steps.append(("gather", dim, axes))
    steps += [("cut", d, reg[d]) for d in cuts if d not in done]
    return LeafLayout(tuple(shape), tuple(spec), block, tuple(reg),
                      tuple(steps), also_sum)


def _narrow(x, dim: int, rng):
    """``x``'s range ``rng`` along ``dim`` (a slice: a view; a tuple of
    slices: their parts concatenated)."""
    if isinstance(rng, slice):
        return x.narrow(dim, rng.start, rng.stop - rng.start)
    return torch.cat([_narrow(x, dim, r) for r in rng], dim=dim)


def _write(whole, dim: int, rng, part) -> None:
    """``_narrow``'s transpose: ``part`` written into ``whole``'s range
    ``rng`` along ``dim``."""
    if isinstance(rng, slice):
        whole.narrow(dim, rng.start, rng.stop - rng.start).copy_(part)
        return
    at = 0
    for r in rng:
        n = r.stop - r.start
        whole.narrow(dim, r.start, n).copy_(part.narrow(dim, at, n))
        at += n


def _take(x, ranges):
    """The part of the whole leaf ``x`` that ``ranges`` (a range a
    dimension: ``LeafLayout.region``) names."""
    for dim, rng in enumerate(ranges):
        if rng != slice(0, x.shape[dim]):
            x = _narrow(x, dim, rng)
    return x


class _GatherLeaf(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, lay: LeafLayout, mesh):
        ctx.lay, ctx.mesh, ctx.shapes = lay, mesh, []
        x = block
        for kind, dim, arg in lay.steps:
            ctx.shapes.append(x.shape)
            if kind == "gather":
                x = gather_raw(x, mesh, arg, dim)
            else:
                x = _narrow(x, dim, arg)
        # a cut is a view: of the block, or of a gathered buffer to free
        return x if lay.steps and lay.steps[-1][0] == "gather" else x.clone()

    @staticmethod
    def backward(ctx, g):
        lay, mesh = ctx.lay, ctx.mesh
        extra = lay.also_sum
        if not lay.steps:
            g = g.clone()                     # summed in place below
        for (kind, dim, arg), shape in zip(reversed(lay.steps),
                                           reversed(ctx.shapes)):
            if kind == "gather":
                g = scatter_raw(g, mesh, arg, dim, also_sum=extra)
                extra = ()
            else:
                whole = torch.zeros(shape, dtype=g.dtype, device=g.device)
                _write(whole, dim, arg, g)
                g = whole
        return all_reduce_(g, mesh, extra), None, None


def gather_leaf(block, lay: LeafLayout, mesh):
    """A parameter leaf's compute block from this rank's storage block:
    all-gathered along the dims where the two differ and cut to the
    compute region (``LeafLayout.steps``).  Backward: the region's
    gradient summed over every rank that computes with this leaf (except
    the batch axes the leaf is not stored over: the step's data-parallel
    reduction sums those) and scattered back into the storage block."""
    if not lay.steps and not lay.also_sum:
        return block
    return _GatherLeaf.apply(block, lay, mesh)


@dataclass(frozen=True)
class Spread:
    """A leaf held in blocks by ranks: this rank's block starts at
    ``start`` (one index a dimension) of the whole leaf of ``shape``, and
    the blocks differ along mesh ``axes`` of ``mesh``: the ranks over
    which a statistic of the whole leaf is taken (``max_``, or an
    all-gather of each block's candidates)."""

    mesh: Any
    axes: Axes
    shape: tuple
    start: tuple

    def max_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` maxed in place over the ranks of ``axes``."""
        return all_reduce_(t, self.mesh, self.axes, op="max")

    def stacked(self, n: int) -> "Spread":
        """The same blocks of ``n`` such leaves stacked on a new leading
        axis (held whole)."""
        return Spread(self.mesh, self.axes, (n,) + self.shape,
                      (0,) + self.start)


class ParamLayout:
    """Every parameter leaf of a model on a mesh of ranks: its
    ``LeafLayout`` by name, ``resident`` ``"storage"`` (training: the
    rank holds its ``param_specs`` block of each leaf, gathered on use)
    or ``"compute"`` (serving: it holds its compute block, gathered once
    where the session starts), and the rules its compute follows."""

    def __init__(self, leaves: dict, rules: MeshRules, resident: str):
        if resident not in ("storage", "compute"):
            raise ValueError(f"resident={resident!r}")
        self.leaves = leaves
        self.rules = rules
        self.mesh = rules.mesh
        self.resident = resident
        self.batch_axes = tuple(a for a in rules.axes("batch")
                                if self.mesh.shape[a] > 1)

    def owner(self, name: str) -> bool:
        """Whether this rank counts leaf ``name``'s block once among the
        ranks that hold the same block (coordinate 0 along every axis the
        leaf is not stored over)."""
        held = self.leaves[name].storage_axes
        return all(self.mesh.coords[a] == 0 for a in self.mesh.axis_names
                   if a not in held)

    def dp_axes(self, name: str) -> Axes:
        """The batch axes a gradient of leaf ``name`` is still summed over
        after the backward: those it is not stored over."""
        held = self.leaves[name].storage_axes
        return tuple(a for a in self.batch_axes if a not in held)

    def block(self, name: str, full):
        """This rank's resident block of the whole leaf ``full``."""
        lay = self.leaves[name]
        if self.resident == "storage":
            return full[lay.block].clone()
        return _take(full, lay.region).clone()

    def use(self, name: str, p):
        """The compute block of resident parameter ``p``."""
        if self.resident == "compute":
            return p
        return gather_leaf(p, self.leaves[name], self.mesh)

    def unshard(self, name: str, block):
        """The whole leaf from its storage blocks (for checkpoints)."""
        return unshard_leaf(block, self.leaves[name].spec, self.mesh)

    def spread(self, name: str) -> Spread | None:
        """How leaf ``name``'s storage blocks lie over the ranks, or
        ``None`` where every rank holds it whole."""
        lay = self.leaves[name]
        axes = tuple(a for a in lay.storage_axes if self.mesh.shape[a] > 1)
        if not axes:
            return None
        return Spread(self.mesh, axes, lay.shape,
                      tuple(b.start for b in lay.block))

    def moment_grids(self) -> dict:
        """The ``Spread`` along its last axis of every leaf whose storage
        blocks straddle blocks of ``adamw.BLOCK`` columns of the whole
        leaf's quantization grid: its int8 moments are quantized on that
        grid, each straddling block's statistic maxed over the ranks that
        share the last axis.  A leaf cut at multiples of ``BLOCK`` (or not
        cut along it) is quantized block by block, with no collective."""
        from ..optim.adamw import BLOCK

        cached = self.__dict__.get("_grids")
        if cached is None:
            cached = {}
            for name, lay in self.leaves.items():
                axes = _entry_axes(lay.spec[-1]) if lay.spec else ()
                n = self.mesh.axes_size(axes)
                if n <= 1 or (lay.shape[-1] // n) % BLOCK == 0:
                    continue
                cached[name] = Spread(self.mesh, axes, lay.shape,
                                      tuple(b.start for b in lay.block))
            self._grids = cached
        return cached

    def shard_moment(self, name: str, m):
        """This rank's block of a whole moment leaf (a tensor, or an int8
        moment's ``{"q", "scale"[, "minv"]}``).  ``adamw`` quantizes along
        the last axis: a leaf cut along it keeps ``q`` for the rank's
        columns and the scales of the whole grid along its rows
        (``moment_grids``); any other leaf's parts are blocked as it is."""
        spec = self.leaves[name].spec
        if isinstance(m, Mapping):
            if name not in self.moment_grids():
                return {k: self.shard_moment(name, v) for k, v in m.items()}
            # q as the leaf (its padding dropped), the scales whole along
            # the grid
            shape = self.leaves[name].shape
            s_spec = spec[:-1] + (None,)
            return {k: (v[..., :shape[-1]][block_slices(shape, spec,
                                                         self.mesh)]
                        if k == "q" else
                        v[block_slices(v.shape, s_spec, self.mesh)]).clone()
                    for k, v in m.items()}
        return m[block_slices(m.shape, spec, self.mesh)].clone()

    def unshard_moment(self, name: str, m):
        """``shard_moment``'s inverse.  A grid's ``q`` is padded as
        ``adamw.quantize_moment`` pads the whole leaf: codes 0 (linear)
        and -127 (logarithmic: the padding is its block's minimum)."""
        spec = self.leaves[name].spec
        if isinstance(m, Mapping):
            if name not in self.moment_grids():
                return {k: self.unshard_moment(name, v)
                        for k, v in m.items()}
            from ..optim.adamw import BLOCK

            q = unshard_leaf(m["q"], spec, self.mesh)
            pad = (-q.shape[-1]) % BLOCK
            out = {"q": torch.nn.functional.pad(
                q, (0, pad), value=-127 if "minv" in m else 0)}
            for k in m:
                if k != "q":
                    out[k] = unshard_leaf(m[k], spec[:-1] + (None,),
                                          self.mesh)
            return out
        return unshard_leaf(m, spec, self.mesh)

    def global_norm(self, grads: Mapping) -> torch.Tensor:
        """The global norm of the whole gradient from each rank's blocks:
        each distinct block's squares counted once (``owner``), summed
        over every rank."""
        some = next(iter(grads.values()))
        sq = torch.zeros((), dtype=torch.float32, device=some.device)
        for name, g in grads.items():
            if self.owner(name):
                sq = sq + g.float().square().sum()
        return all_reduce_(sq, self.mesh, self.mesh.axis_names).sqrt()
