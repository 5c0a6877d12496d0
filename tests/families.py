"""Matrix families the operator tests run over, each paired with the
operator that packs it.  Every family is small, made from a seed, and
cached per test process."""

import functools

import numpy as np
import scipy.sparse as sp

import bench
import vbcs_tpu as v
from corpus import NAMES, load_corpus
from vbcs_tpu.formats.partition import SplitPartition
from vbcs_tpu.operator import VBC2DOperator, VBCOperator


class FixedChunker:
    """A chunker that returns a given column partition."""

    def __init__(self, spl):
        self.spl = np.asarray(spl, dtype=np.int64)

    def partition(self, A):
        return SplitPartition(self.spl)


def _f64(A):
    return A.astype(np.float64).tocsc()


def _uniform8():
    A = _f64(bench.blocky_matrix(L=64, w=8, d=6, band=40, seed=3))
    return A, VBCOperator.from_csc(A, W=8, method=v.EquiChunker(8),
                                   reorder="never")


def _mixed48():
    A = _f64(bench.blocky_matrix(L=96, w=6, d=5, band=50, seed=4))
    widths = np.resize([8, 4], 96)
    spl = np.concatenate([[0], np.cumsum(widths)])
    spl = spl[spl < A.shape[1]]
    spl = np.append(spl, A.shape[1])
    c = FixedChunker(spl)
    return A, VBCOperator.from_csc(A, W=8, method=c, reorder="never")


def _nonsquare():
    A = _f64(sp.random(150, 230, 0.05, random_state=5, format="csc"))
    return A, VBCOperator.from_csc(A, W=8)


def _empty_rows_cols():
    A = sp.random(120, 120, 0.08, random_state=6, format="lil")
    A[10:20, :] = 0
    A[:, 40:47] = 0
    A[:, 119] = 0
    A = _f64(A)
    A.eliminate_zeros()
    return A, VBCOperator.from_csc(A, W=8)


def _fem_rcm():
    A = _f64(bench.fem_matrix(k=40, seed=1))  # 1600 rows > 1024
    op = VBCOperator.from_csc(A, W=4, reorder="always")
    assert op.row_perm is not None
    return A, op


def _tiles2d():
    A = _f64(bench.blocky2d_matrix(K=64, u=4, w=8, d=4, band=10, seed=2))
    op = VBC2DOperator.from_csc(
        A, U=4, W=8,
        method=v.AlternatingPacker(v.EquiChunker(8), v.EquiChunker(4)),
        method_forward=v.AlternatingPacker(v.EquiChunker(4),
                                           v.EquiChunker(8)))
    return A, op


def _square2d():
    A = _f64(load_corpus()["HB/can_292"])
    return A, VBC2DOperator.from_csc(A, U=4, W=4)


BUILDERS = {
    **{name: None for name in NAMES},
    "uniform_w8": _uniform8,
    "mixed_w4_w8": _mixed48,
    "non_square": _nonsquare,
    "empty_rows_cols": _empty_rows_cols,
    "fem_auto_rcm": _fem_rcm,
    "tiles_2d": _tiles2d,
    "square_2d": _square2d,
}


@functools.lru_cache(maxsize=None)
def family(name):
    """(A as a float64 scipy CSC matrix, the operator of A)."""
    build = BUILDERS[name]
    if build is None:
        A = _f64(load_corpus()[name])
        return A, VBCOperator.from_csc(A, W=8)
    return build()
