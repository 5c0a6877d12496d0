"""Row/column reordering for x-gather locality.

TrSpMV gathers ``x`` at every block's row, so the *row bandwidth* of
neighbouring stripes decides how scattered those reads are — a locality
cost with no direct analog in the reference (whose CPU caches absorb
scattered access; the closest analog is the cache-resident working set
its autotuner assumes, ``src/costs.jl:44-60``).  These reorderings
bound it:

* :func:`rcm_rows` — reverse Cuthill-McKee on the symmetrized graph
  (square matrices), the classical bandwidth reducer;
* :func:`profile_rows` — order rows by mean column position (works for
  rectangular matrices and as an RCM fallback).

Both return ``(A_perm, perm)`` with ``A_perm = A[perm, :]``; for
``y = A.T @ x`` the only change is ``x -> x[perm]`` (the output needs no
un-permutation, since columns are untouched).
"""

from __future__ import annotations

import numpy as np

from ..formats.csc import CSC

__all__ = ["rcm_rows", "profile_rows", "apply_row_perm"]


def apply_row_perm(A: CSC, perm: np.ndarray) -> CSC:
    """A[perm, :] as CSC (rows relabeled by rank of perm)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)
    import scipy.sparse as sp

    S = A.to_scipy().tocoo()
    return CSC.from_scipy(
        sp.coo_matrix((S.data, (inv[S.row], S.col)), shape=(A.m, A.n))
    )


def rcm_rows(A: CSC):
    """Reverse Cuthill-McKee row ordering (square: on A + A.T)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = A.to_scipy()
    if A.m == A.n:
        G = (S + S.T).tocsr()
    else:
        G = (S @ S.T).tocsr()  # row connectivity graph
    perm = np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True))
    return apply_row_perm(A, perm), perm


def profile_rows(A: CSC):
    """Order rows by mean column index of their nonzeros."""
    S = A.to_scipy().tocsr()
    counts = np.maximum(1, np.diff(S.indptr))
    sums = np.add.reduceat(
        S.indices, S.indptr[:-1], dtype=np.float64
    ) * (np.diff(S.indptr) > 0)
    mean = sums / counts
    mean[np.diff(S.indptr) == 0] = np.inf  # empty rows last
    perm = np.argsort(mean, kind="stable")
    return apply_row_perm(A, perm), perm


def rcm_symmetric(A: CSC):
    """Symmetric RCM: ``A_perm = A[perm][:, perm]`` (square only).

    Keeps chained SpMV composable — a symmetric relabeling means the
    permuted operator maps permuted space to permuted space, so
    iterative solves pay the boundary permutation once, not per
    multiply."""
    assert A.m == A.n, "symmetric reorder needs a square matrix"
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = A.to_scipy().tocsr()
    sym = (S + S.T).tocsr()
    perm = np.asarray(reverse_cuthill_mckee(sym, symmetric_mode=True))
    Sp = S[perm][:, perm].tocsc()
    return CSC.from_scipy(Sp), perm


def window_badness(B, ng: int = 1024, max_w: int = 6) -> float:
    """Fraction of runs of 128 consecutive 8-block groups whose rows
    span more than ``max_w`` aligned 1024-row windows — a cheap
    pack-free estimate of how scattered the x-gather of the block
    stream is.  The auto-RCM decision in ``VBCOperator.from_csc`` reads
    it."""
    nb = (B.pos[1:] - B.pos[:-1]).astype(np.int64)
    ngr = np.maximum(1, -(-nb // 8))
    grp_stripe = np.repeat(np.arange(nb.size), ngr)
    run_of_grp = np.arange(grp_stripe.size) // 128
    # window span per run over each stripe's row range (cheap proxy:
    # use min/max row of the stripe)
    lo = np.zeros(nb.size, dtype=np.int64)
    hi = np.zeros(nb.size, dtype=np.int64)
    for l in range(nb.size):
        sl = B.idx[B.pos[l]:B.pos[l + 1]]
        if sl.size:
            lo[l], hi[l] = sl.min() >> 10, sl.max() >> 10
    nrun = int(run_of_grp.max()) + 1 if run_of_grp.size else 1
    vlo = np.full(nrun, np.iinfo(np.int64).max)
    vhi = np.zeros(nrun, dtype=np.int64)
    np.minimum.at(vlo, run_of_grp, lo[grp_stripe])
    np.maximum.at(vhi, run_of_grp, hi[grp_stripe])
    spans = np.maximum(vhi - np.minimum(vlo, vhi) + 1, 1)
    return float((spans > max_w).mean())
