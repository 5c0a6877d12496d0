"""CSC/CSR device baseline kernels.

The device analog of the reference's un-blocked CSC TrSpMV baseline
(``src/TrSpMV.jl:1-20``), used as the comparison point in benchmarks
(``bin/test_table.jl:34-44``): a flat gather + segment-sum over the raw
CSC arrays, with no block structure.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.csc import CSC

__all__ = ["CSCDevice", "csc_tr_spmv", "csc_spmv"]


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["col", "rowidx", "val"],
    meta_fields=["m", "n"],
)
@dataclasses.dataclass(frozen=True)
class CSCDevice:
    """Flattened CSC: per-nonzero column id (expanded colptr), row index,
    value.  Padded nonzeros carry col == n (dropped segment)."""

    m: int
    n: int
    col: jax.Array  # [nnz_pad] int32
    rowidx: jax.Array  # [nnz_pad] int32
    val: jax.Array  # [nnz_pad]

    @staticmethod
    def from_host(A: CSC, dtype=None, pad: int = 8) -> "CSCDevice":
        dtype = np.dtype(dtype or A.val.dtype)
        nnz = A.nnz
        nnz_pad = max(pad, -(-nnz // pad) * pad)
        col = np.full(nnz_pad, A.n, dtype=np.int32)
        col[:nnz] = np.repeat(
            np.arange(A.n, dtype=np.int32), np.diff(A.pos)
        )
        rowidx = np.zeros(nnz_pad, dtype=np.int32)
        rowidx[:nnz] = A.idx
        val = np.zeros(nnz_pad, dtype=dtype)
        val[:nnz] = A.val.astype(dtype)
        return jax.device_put(
            CSCDevice(m=A.m, n=A.n, col=col, rowidx=rowidx, val=val)
        )

    @property
    def nbytes(self) -> int:
        return (
            self.col.size * 4
            + self.rowidx.size * 4
            + self.val.size * self.val.dtype.itemsize
        )


def csc_tr_spmv(A: CSCDevice, x: jax.Array) -> jax.Array:
    """y = A.T @ x: gather x at row indices, segment-sum by column."""
    prod = A.val.astype(x.dtype) * x[A.rowidx]
    return jax.ops.segment_sum(prod, A.col, num_segments=A.n + 1)[: A.n]


def csc_spmv(A: CSCDevice, x: jax.Array) -> jax.Array:
    """y = A @ x: gather x at columns (OOB pad -> 0), scatter-add by row."""
    xg = jnp.take(x, A.col, mode="fill", fill_value=0)
    prod = A.val.astype(x.dtype) * xg
    return jnp.zeros(A.m, dtype=x.dtype).at[A.rowidx].add(prod)
