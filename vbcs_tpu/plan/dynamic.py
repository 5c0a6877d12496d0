"""Optimal partitioning by dynamic programming — ``DynamicTotalChunker``.

Native re-implementation of the "optimal partitioning" half of the paper
(arXiv:2005.12414) as exposed through ChainPartitioners.jl's
``DynamicTotalChunker(model[, W])`` (SURVEY.md §2.9): choose column split
points minimizing the *total* model cost

    sum_stripes  cost(stripe)

subject to stripe width <= W, where ``cost`` is one of the models in
:mod:`vbcs_tpu.models.cost`.  The DP is

    opt[j'] = min_{j' - W <= j < j'}  opt[j] + stripe_cost(j, j')

with ``stripe_cost`` needing the number of *distinct rows* (1-D models) or
the rank-R weighted sums of *distinct row-blocks* (2-D separable models)
in columns ``[j, j')``.  Those window statistics are maintained
incrementally with a last-occurrence counter (the same trick the
reference converter uses for its histogram pass,
``src/constructors_1DVBC.jl:22-30``): when sweeping ``j'`` rightward,
``cnt[c]`` holds the weight of rows whose *last* occurrence in ``[0, j')``
is column ``c``; the distinct weight in ``[j, j')`` is then
``sum(cnt[j:j'])``, a W-suffix sum.  Total cost: O(nnz + n * W).

Tie-breaking: among equal-cost choices the *narrowest* stripe wins
(documented deviation-tolerant choice — ChainPartitioners' internal
ordering is unspecified; cost equality, not split equality, is the
correctness contract, SURVEY.md §7 "hard parts").
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..formats.csc import CSC
from ..formats.partition import SplitPartition
from ..models.cost import (
    AffineConnectivityModel,
    AffineFillNetCostModel,
    BlockComponentCostModel,
    ColumnBlockComponentCostModel,
    component_table,
    constraint_cap,
    unwrap,
)

__all__ = ["DynamicTotalChunker", "dp_partition"]


@dataclasses.dataclass(frozen=True)
class DynamicTotalChunker:
    """Optimal DP chunker (reference ``DynamicTotalChunker(model, W)`` /
    ``DynamicTotalChunker(ConstrainedCost(model, VertexCount(), W))``)."""

    model: object
    w_max: int | None = None

    def partition(self, A: CSC, row_partition: SplitPartition | None = None):
        W = constraint_cap(self.model, self.w_max)
        if W is None:
            raise ValueError(
                "DynamicTotalChunker needs a width cap: pass w_max or wrap "
                "the model in ConstrainedCost(model, VertexCount(), W)"
            )
        return dp_partition(A, unwrap(self.model), int(W), row_partition)


def _cost_closure(model, W: int, heights: np.ndarray | None):
    """Build (weights_per_rank, cost_fn) for the DP.

    ``weights_per_rank[r][g]`` is the weight that distinct group ``g``
    (row for 1-D, row-block for 2-D) contributes to counter ``r``.
    ``cost_fn(widths, counts, nnzs)`` evaluates the candidate stripe costs,
    vectorized over the width axis (``counts`` has shape [R, len(widths)]).
    """
    if isinstance(model, ColumnBlockComponentCostModel):
        alpha = model.alpha_table(W)
        beta = model.beta_table(W)
        gamma = model.gamma_table(W)

        if np.any(gamma != 0):
            # per-EXCESS-8-block-group term; see
            # ColumnBlockComponentCostModel.gamma_col
            def cost_fn(widths, counts, nnzs):
                excess = np.maximum(-(-counts[0] // 8) - 1, 0)
                return (alpha[widths - 1] + counts[0] * beta[widths - 1]
                        + excess * gamma[widths - 1])
        else:
            def cost_fn(widths, counts, nnzs):
                return alpha[widths - 1] + counts[0] * beta[widths - 1]

        return None, cost_fn  # None => unit weights, groups = rows

    if isinstance(model, AffineConnectivityModel):

        def cost_fn(widths, counts, nnzs):
            return (
                model.alpha
                + model.beta_vertex * widths
                + model.beta_pin * nnzs
                + model.beta_net * counts[0]
            )

        return None, cost_fn

    if isinstance(model, AffineFillNetCostModel):

        def cost_fn(widths, counts, nnzs):
            return (
                model.alpha
                + model.beta_vertex * widths
                + model.beta_net * counts[0]
                + model.beta_fill * counts[0] * widths
            )

        return None, cost_fn

    if isinstance(model, BlockComponentCostModel):
        if heights is None:
            raise ValueError("2-D model requires a row partition")
        alpha_col = component_table(model.alpha_col, W)
        beta_col = np.stack(
            [component_table(c, W) for c in model.beta_col]
        )  # [R, W]
        umax = int(heights.max(initial=1))
        weights = np.stack(
            [
                np.concatenate([[0.0], component_table(c, umax)])[heights]
                for c in model.beta_row
            ]
        )  # [R, K]: weights[r][k] = beta_row[r](u_k); height-0 blocks weigh 0

        def cost_fn(widths, counts, nnzs):
            # counts: [R, nw]; beta_col[:, widths-1]: [R, nw]
            return alpha_col[widths - 1] + np.einsum(
                "rw,rw->w", counts, beta_col[:, widths - 1]
            )

        return weights, cost_fn

    raise TypeError(f"unsupported cost model {type(model).__name__}")


def _native_tables(model, W, heights):
    """(alpha_tab, beta_tabs [R,W], gamma_tab|None, weights|None,
    delta_tab|None) for the C++ DP, or None if the model shape isn't
    table-expressible.  delta charges per EXCESS 8-block group (the
    gamma_col extension)."""
    ws = np.arange(1, W + 1, dtype=np.float64)
    if isinstance(model, ColumnBlockComponentCostModel):
        gam = model.gamma_table(W)
        delta = gam if np.any(gam != 0) else None
        return (model.alpha_table(W), model.beta_table(W)[None, :], None,
                None, delta)
    if isinstance(model, AffineConnectivityModel):
        return (
            model.alpha + model.beta_vertex * ws,
            np.full((1, W), float(model.beta_net)),
            np.full(W, float(model.beta_pin)),
            None,
            None,
        )
    if isinstance(model, AffineFillNetCostModel):
        return (
            model.alpha + model.beta_vertex * ws,
            (model.beta_net + model.beta_fill * ws)[None, :],
            None,
            None,
            None,
        )
    if isinstance(model, BlockComponentCostModel):
        alpha = component_table(model.alpha_col, W)
        betas = np.stack([component_table(c, W) for c in model.beta_col])
        umax = int(heights.max(initial=1))
        weights = np.stack(
            [
                np.concatenate([[0.0], component_table(c, umax)])[heights]
                for c in model.beta_row
            ]
        )
        return alpha, betas, None, weights, None
    return None


def dp_partition(
    A: CSC,
    model,
    W: int,
    row_partition: SplitPartition | None = None,
) -> SplitPartition:
    """Run the split-point DP; returns the optimal column partition.

    Uses the C++ implementation (vbcs_tpu.native) when available; the
    NumPy path below is the bitwise oracle and fallback.
    """
    if W < 1:
        raise ValueError(f"width cap W must be >= 1, got {W}")
    n, m = A.n, A.m
    if n == 0:
        return SplitPartition.whole(0)
    pos, idx = A.pos, A.idx

    try:
        from ..native import dp_partition_native

        if isinstance(model, BlockComponentCostModel):
            Pi0 = row_partition or SplitPartition.trivial(m)
            grp = Pi0.to_map().asg[idx]
            hts = Pi0.widths().astype(np.int64)
            ng = len(Pi0)
        else:
            grp = idx
            hts = None
            ng = m
        tabs = _native_tables(model, W, hts)
        if tabs is not None:
            alpha_tab, beta_tabs, gamma_tab, weights, delta_tab = tabs
            spl = dp_partition_native(
                n, ng, pos, grp, W, alpha_tab, beta_tabs, gamma_tab,
                weights, delta_tab,
            )
            if spl is not None:
                return SplitPartition(spl)
    except Exception:
        pass  # fall through to the NumPy oracle

    is_2d = isinstance(model, BlockComponentCostModel)
    if is_2d:
        Pi = row_partition or SplitPartition.trivial(m)
        asg = Pi.to_map().asg
        heights = Pi.widths().astype(np.int64)
        num_groups = len(Pi)
    else:
        asg = None
        heights = None
        num_groups = m

    weights, cost_fn = _cost_closure(model, W, heights)
    if weights is None:
        R = 1
        weights = np.ones((1, max(num_groups, 1)))
    else:
        R = weights.shape[0]

    # Per-column distinct group lists.
    lst = np.full(max(num_groups, 1), -1, dtype=np.int64)
    cnt = np.zeros((R, n), dtype=np.float64)

    INF = np.inf
    opt = np.full(n + 1, INF)
    opt[0] = 0.0
    prev = np.zeros(n + 1, dtype=np.int64)

    for jp in range(1, n + 1):
        c = jp - 1
        rows_c = idx[pos[c] : pos[c + 1]]
        g = rows_c if not is_2d else np.unique(asg[rows_c])
        if g.size:
            old = lst[g]
            seen = old >= 0
            if np.any(seen):
                np.subtract.at(cnt.T, (old[seen],), weights[:, g[seen]].T)
            cnt[:, c] += weights[:, g].sum(axis=1)
            lst[g] = c
        W_eff = min(W, jp)
        win = cnt[:, jp - W_eff : jp]  # columns jp-W_eff .. jp-1
        counts = np.cumsum(win[:, ::-1], axis=1)  # counts[:, w-1] = window sum
        widths = np.arange(1, W_eff + 1, dtype=np.int64)
        nnzs = (pos[jp] - pos[jp - widths]).astype(np.float64)
        cand = opt[jp - widths] + cost_fn(widths, counts, nnzs)
        t = int(np.argmin(cand))  # first min => narrowest stripe on ties
        opt[jp] = cand[t]
        prev[jp] = jp - int(widths[t])

    # Backtrack split points.
    splits = [n]
    j = n
    while j > 0:
        j = int(prev[j])
        splits.append(j)
    splits.reverse()
    return SplitPartition(np.asarray(splits, dtype=np.int64))
