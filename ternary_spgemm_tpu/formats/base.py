"""Abstract interface for ternary sparse containers.

The analogue of the reference's ``DataStructureInterface``
(``cpp_impl/data_structures/DataStructureInterface.hpp:4-14``): every format
can be built from a dense ternary matrix and converted back
(``init`` / ``getVectorRepresentation`` round-trip), and reports its byte
footprint (``getDataStructureSize``). Unlike the reference — where none of the
concrete formats actually implemented the interface (SURVEY.md §2.1) — every
format here subclasses :class:`TernaryFormat`, and the round-trip tests in
``tests/test_formats_roundtrip.py`` run against all of them.

Formats hold **host NumPy arrays** (construction is a host-side, one-time
cost, exactly as in the reference where format building sits outside the
timed region, ``main.cpp:60-81``). Each concrete format is registered as a
JAX pytree whose leaves are its index/value arrays, so a format instance can
be passed straight into ``jax.jit``-ed kernels; static shape metadata (K, N,
capacities) lives in the pytree aux data and therefore specializes the
compiled kernel.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar, Dict, Type

import jax
import numpy as np

_FORMAT_REGISTRY: Dict[str, Type["TernaryFormat"]] = {}


def register_format(cls):
    """Class decorator: register a format and make it a JAX pytree.

    Array-typed dataclass fields become pytree leaves; everything else
    (ints, tuples, dtypes) is static aux data.
    """
    cls = dataclasses.dataclass(frozen=True, eq=False)(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    array_fields = [f for f in fields if f in getattr(cls, "ARRAY_FIELDS", fields)]
    static_fields = [f for f in fields if f not in array_fields]

    def flatten(obj):
        leaves = tuple(getattr(obj, f) for f in array_fields)
        aux = tuple(getattr(obj, f) for f in static_fields)
        return leaves, aux

    def unflatten(aux, leaves):
        kwargs = dict(zip(array_fields, leaves))
        kwargs.update(dict(zip(static_fields, aux)))
        return cls(**kwargs)

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    _FORMAT_REGISTRY[cls.__name__] = cls
    return cls


def all_formats() -> Dict[str, Type["TernaryFormat"]]:
    return dict(_FORMAT_REGISTRY)


class TernaryFormat(abc.ABC):
    """Base class for ternary sparse containers (see module docstring)."""

    #: subclasses list which dataclass fields are arrays (pytree leaves)
    ARRAY_FIELDS: ClassVar[tuple] = ()

    @classmethod
    @abc.abstractmethod
    def from_dense(cls, W: np.ndarray, **kwargs) -> "TernaryFormat":
        """Build the container from a dense ``(K, N)`` int matrix in {-1,0,1}."""

    @abc.abstractmethod
    def to_dense(self) -> np.ndarray:
        """Reconstruct the dense ``(K, N)`` int8 matrix (round-trip check)."""

    @abc.abstractmethod
    def size_bytes(self) -> int:
        """Byte footprint of the container (``getDataStructureSize`` analogue).

        Used by the instrumentation layer for the operational-intensity
        accounting ``total_input_bytes = 4*(M*K + M*N + N) + size_bytes``
        (``main.cpp:264-271``).
        """

    @property
    @abc.abstractmethod
    def shape(self) -> tuple:
        """Logical dense shape ``(K, N)``."""

    @property
    def nnz(self) -> int:
        d = self.to_dense()
        return int(np.count_nonzero(d))

    def prepare(self, M: int) -> "TernaryFormat":
        """Materialize any M-dependent derived views a kernel will need
        (host-side, outside timed regions — the ``main.cpp:60-81``
        convention). Default: nothing to do. TCSC overrides this to build
        its padded gather tables only when the M-chunked path will run."""
        return self


def _as_int8_dense(W: np.ndarray) -> np.ndarray:
    W = np.asarray(W)
    if not np.isin(np.unique(W), (-1, 0, 1)).all():
        raise ValueError("dense ternary matrix must only contain {-1, 0, +1}")
    return W.astype(np.int8)
