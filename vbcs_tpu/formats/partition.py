"""Contiguous partitions of an index range.

Re-design of the partition carriers used throughout the
reference library (``SplitPartition`` / ``MapPartition`` from
ChainPartitioners.jl; see reference ``src/SparseMatrixVBCs.jl:39,65`` and
``src/constructors_VBC.jl:22``).  All indexing here is 0-based.

A :class:`SplitPartition` of the range ``[0, n)`` into ``K`` contiguous
chunks is stored as a split-point vector ``spl`` of length ``K + 1`` with
``spl[0] == 0``, ``spl[K] == n`` and ``spl`` nondecreasing: chunk ``k``
covers ``[spl[k], spl[k+1])``.

A :class:`MapPartition` stores the inverse view: ``asg[i]`` is the chunk
that element ``i`` belongs to.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SplitPartition", "MapPartition"]


@dataclasses.dataclass(frozen=True)
class SplitPartition:
    """Contiguous partition given by split points (0-based, half-open)."""

    spl: np.ndarray  # int array, shape [K + 1]

    def __post_init__(self):
        spl = np.asarray(self.spl)
        if spl.ndim != 1 or spl.size < 1:
            raise ValueError("spl must be a 1-D array of length >= 1")
        if spl[0] != 0:
            raise ValueError("spl[0] must be 0")
        if np.any(np.diff(spl) < 0):
            raise ValueError("spl must be nondecreasing")
        object.__setattr__(self, "spl", spl.astype(np.int64))

    def __len__(self) -> int:
        """Number of chunks."""
        return int(self.spl.size - 1)

    @property
    def n(self) -> int:
        """Size of the partitioned range."""
        return int(self.spl[-1])

    def widths(self) -> np.ndarray:
        """Chunk sizes, shape [K]."""
        return np.diff(self.spl)

    def chunk(self, k: int) -> tuple[int, int]:
        """Half-open range [start, stop) of chunk ``k``."""
        return int(self.spl[k]), int(self.spl[k + 1])

    def to_map(self) -> "MapPartition":
        """Element->chunk assignment (reference: ``convert(MapPartition, Π)``)."""
        widths = self.widths()
        asg = np.repeat(np.arange(len(self), dtype=np.int64), widths)
        return MapPartition(asg=asg, num_chunks=len(self))

    def max_width(self) -> int:
        return int(self.widths().max(initial=0))

    @staticmethod
    def equi(n: int, w: int) -> "SplitPartition":
        """Fixed-width partition: chunks of size ``w`` (last may be smaller)."""
        if w <= 0:
            raise ValueError("w must be > 0")
        spl = np.arange(0, n + w, w, dtype=np.int64)
        spl[-1] = n
        if spl.size >= 2 and spl[-1] == spl[-2]:
            spl = spl[:-1]
        if n == 0:
            spl = np.zeros(1, dtype=np.int64)
        return SplitPartition(spl)

    @staticmethod
    def trivial(n: int) -> "SplitPartition":
        """Every element its own chunk."""
        return SplitPartition(np.arange(n + 1, dtype=np.int64))

    @staticmethod
    def whole(n: int) -> "SplitPartition":
        """One chunk covering everything."""
        return SplitPartition(np.array([0, n], dtype=np.int64))

    def __eq__(self, other) -> bool:
        return isinstance(other, SplitPartition) and np.array_equal(
            self.spl, other.spl
        )

    def __hash__(self):
        return hash(self.spl.tobytes())


@dataclasses.dataclass(frozen=True)
class MapPartition:
    """Element->chunk assignment (must be nondecreasing for VBC use)."""

    asg: np.ndarray  # int array, shape [n]
    num_chunks: int

    def __len__(self) -> int:
        return int(self.num_chunks)

    def to_split(self) -> SplitPartition:
        """Convert back to split points. Requires ``asg`` to be contiguous
        (nondecreasing, covering 0..num_chunks-1)."""
        asg = np.asarray(self.asg)
        if asg.size and np.any(np.diff(asg) < 0):
            raise ValueError("asg must be nondecreasing to convert to splits")
        counts = np.bincount(asg, minlength=self.num_chunks)
        spl = np.zeros(self.num_chunks + 1, dtype=np.int64)
        np.cumsum(counts, out=spl[1:])
        return SplitPartition(spl)
