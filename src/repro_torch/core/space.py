"""Discrete configuration spaces for combinatorial optimization.

The paper (Memeti & Pllana, ICPPW'16) searches a product space of discrete
parameters (threads, affinity, workload fraction).  ``ConfigSpace`` is the
generic substrate: an ordered set of named parameters, each with a finite
value tuple, plus the three operations every search strategy needs:

  * ``random``     — uniform sample (SA initialisation),
  * ``neighbor``   — local move (SA proposal): ordinal parameters step to an
                     adjacent value, categorical parameters resample,
  * ``encode``     — map a config to a numeric feature vector for the
                     machine-learning evaluator (ordinal -> value,
                     categorical -> one-hot).

Configs are plain dicts ``{param_name: value}``; an index-vector codec
(``to_indices``/``from_indices``) supports the vectorized SA chains.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Iterator, Mapping, Sequence

import numpy as np

__all__ = ["Param", "ConfigSpace"]


@dataclass(frozen=True)
class Param:
    """One discrete parameter.

    ``ordinal=True`` means the values have a meaningful order (e.g. thread
    counts, workload fraction): neighbor moves step to adjacent values and
    the ML encoding uses the numeric value.  Categorical parameters (e.g.
    thread affinity) resample uniformly and are one-hot encoded.
    """

    name: str
    values: tuple
    ordinal: bool = True

    def __post_init__(self):
        if len(self.values) == 0:
            raise ValueError(f"parameter {self.name!r} has no values")
        if len(set(self.values)) != len(self.values):
            raise ValueError(f"parameter {self.name!r} has duplicate values")

    @property
    def cardinality(self) -> int:
        return len(self.values)


class ConfigSpace:
    """Cartesian product of discrete parameters."""

    def __init__(self, params: Sequence[Param]):
        if not params:
            raise ValueError("empty config space")
        names = [p.name for p in params]
        if len(set(names)) != len(names):
            raise ValueError("duplicate parameter names")
        self.params: tuple[Param, ...] = tuple(params)
        self._by_name = {p.name: p for p in self.params}
        self._value_index = {
            p.name: {v: i for i, v in enumerate(p.values)} for p in self.params
        }

    # -- basic structure ----------------------------------------------------
    @property
    def names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.params)

    def __getitem__(self, name: str) -> Param:
        return self._by_name[name]

    def size(self) -> int:
        """Total number of configurations (Eq. 1 of the paper)."""
        return math.prod(p.cardinality for p in self.params)

    def validate(self, cfg: Mapping[str, Any]) -> None:
        for p in self.params:
            if p.name not in cfg:
                raise KeyError(f"config missing parameter {p.name!r}")
            if cfg[p.name] not in self._value_index[p.name]:
                raise ValueError(
                    f"value {cfg[p.name]!r} not in domain of {p.name!r}"
                )

    # -- sampling and local moves -------------------------------------------
    def random(self, rng: np.random.Generator) -> dict:
        return {p.name: p.values[rng.integers(p.cardinality)] for p in self.params}

    def neighbor(self, cfg: Mapping[str, Any], rng: np.random.Generator,
                 n_moves: int = 1) -> dict:
        """Propose a nearby configuration by perturbing ``n_moves`` parameters."""
        new = dict(cfg)
        # choose distinct parameters to move
        idxs = rng.choice(len(self.params), size=min(n_moves, len(self.params)),
                          replace=False)
        for i in np.atleast_1d(idxs):
            p = self.params[int(i)]
            cur = self._value_index[p.name][new[p.name]]
            if p.ordinal and p.cardinality > 1:
                # step +-1 or +-2 (paper's SA moves within value neighbourhoods)
                step = int(rng.integers(1, 3)) * (1 if rng.random() < 0.5 else -1)
                nxt = min(max(cur + step, 0), p.cardinality - 1)
                if nxt == cur:  # bounced off the boundary: go the other way
                    nxt = min(max(cur - step, 0), p.cardinality - 1)
            else:
                nxt = int(rng.integers(p.cardinality))
            new[p.name] = p.values[nxt]
        return new

    def enumerate(self) -> Iterator[dict]:
        """All configurations — the paper's 'enumeration (brute force)'."""
        for combo in itertools.product(*(p.values for p in self.params)):
            yield dict(zip(self.names, combo))

    # -- batched enumeration (vectorized search engine) ----------------------
    def index_grid(self) -> np.ndarray:
        """All configurations as value-index rows, shape (size, n_params).

        Row order matches ``enumerate()`` (last parameter varies fastest),
        so ``from_indices(index_grid()[k])`` is the k-th enumerated config.
        """
        cards = self.cardinalities
        return np.indices(cards).reshape(len(cards), -1).T.astype(np.int32)

    def enumerate_columns(self, grid: np.ndarray | None = None
                          ) -> dict[str, np.ndarray]:
        """All configurations as per-parameter value columns (size,) each.

        The column-oriented view is what batched oracles consume: no
        per-config dicts are materialized anywhere on the batched path.
        Pass a precomputed ``index_grid()`` to avoid rebuilding it.
        """
        if grid is None:
            grid = self.index_grid()
        return {
            p.name: np.asarray(p.values)[grid[:, i]]
            for i, p in enumerate(self.params)
        }

    def encode_all(self) -> np.ndarray:
        """Feature matrix for the whole space, shape (size, feature_dim).

        Vectorized equivalent of stacking ``encode`` over ``enumerate()``
        (same row order), built by gathering ``index_feature_table`` rows.
        """
        return self.encode_indices(self.index_grid())

    def encode_indices(self, grid: np.ndarray) -> np.ndarray:
        """Encode index rows (n, n_params) into features (n, feature_dim)."""
        grid = np.asarray(grid, dtype=np.int64)
        table, _ = self.index_feature_table()
        out = np.zeros((grid.shape[0], self.feature_dim))
        for i in range(len(self.params)):
            out += table[i, grid[:, i], :]
        return out

    def enumerate_encoded(self) -> tuple[np.ndarray, np.ndarray]:
        """(index_grid, feature_matrix) for the whole space, enumerate order."""
        grid = self.index_grid()
        return grid, self.encode_indices(grid)

    # -- index-vector codec (for vectorized SA) ------------------------------
    def to_indices(self, cfg: Mapping[str, Any]) -> np.ndarray:
        return np.array(
            [self._value_index[p.name][cfg[p.name]] for p in self.params],
            dtype=np.int32,
        )

    def from_indices(self, idx: Sequence[int]) -> dict:
        return {
            p.name: p.values[int(i)] for p, i in zip(self.params, idx, strict=True)
        }

    @property
    def cardinalities(self) -> np.ndarray:
        return np.array([p.cardinality for p in self.params], dtype=np.int32)

    # -- ML feature encoding --------------------------------------------------
    @property
    def feature_dim(self) -> int:
        return sum(1 if p.ordinal else p.cardinality for p in self.params)

    @property
    def feature_names(self) -> list[str]:
        out: list[str] = []
        for p in self.params:
            if p.ordinal:
                out.append(p.name)
            else:
                out.extend(f"{p.name}={v}" for v in p.values)
        return out

    def encode(self, cfg: Mapping[str, Any]) -> np.ndarray:
        """Config -> float feature vector (ordinal value / categorical one-hot)."""
        feats: list[float] = []
        for p in self.params:
            if p.ordinal:
                feats.append(float(cfg[p.name]))
            else:
                one_hot = [0.0] * p.cardinality
                one_hot[self._value_index[p.name][cfg[p.name]]] = 1.0
                feats.extend(one_hot)
        return np.asarray(feats, dtype=np.float64)

    def encode_many(self, cfgs: Sequence[Mapping[str, Any]]) -> np.ndarray:
        return np.stack([self.encode(c) for c in cfgs]) if cfgs else \
            np.zeros((0, self.feature_dim))

    # Encoding table used by the vectorized (index-based) SA: row i maps
    # value-index -> feature columns for parameter i.
    def index_feature_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (table, col_offsets).

        ``table[i, j, :]`` is the feature contribution of parameter ``i``
        taking value-index ``j``, padded to the max cardinality; summing the
        per-parameter rows into their column ranges reproduces ``encode``.
        """
        max_card = int(self.cardinalities.max())
        table = np.zeros((len(self.params), max_card, self.feature_dim))
        col = 0
        offsets = []
        for i, p in enumerate(self.params):
            offsets.append(col)
            if p.ordinal:
                for j, v in enumerate(p.values):
                    table[i, j, col] = float(v)
                col += 1
            else:
                for j in range(p.cardinality):
                    table[i, j, col + j] = 1.0
                col += p.cardinality
        return table, np.asarray(offsets, dtype=np.int32)

    def __repr__(self) -> str:
        inner = ", ".join(f"{p.name}[{p.cardinality}]" for p in self.params)
        return f"ConfigSpace({inner}, size={self.size()})"


def paper_space(workload_step: int = 1) -> ConfigSpace:
    """The exact parameter space of the paper (Table I).

    ``workload_step=1`` gives fractions {0..100} and a total of
    7*9*3*3*101 = 57,267 raw combinations; the paper reports 19,926
    *experiments* because host-only/device-only rows collapse the other
    side's parameters.  ``ConfigSpace`` counts raw combinations; the
    effort accounting in the autotuner de-duplicates collapsed configs.
    """
    return ConfigSpace([
        Param("host_threads", (2, 4, 6, 12, 24, 36, 48)),
        Param("device_threads", (2, 4, 8, 16, 30, 60, 120, 180, 240)),
        Param("host_affinity", ("none", "scatter", "compact"), ordinal=False),
        Param("device_affinity", ("balanced", "scatter", "compact"), ordinal=False),
        Param("host_fraction", tuple(range(0, 101, workload_step))),
    ])
