"""Planner correctness: DP optimality vs brute force, cost-model fidelity.

The reference's correctness contract for the planner is that
``total_value`` reproduces the optimal partition *cost* (BASELINE.md:
"verify the planner reproduces the reference's optimal partition
costs") — we verify our DP is truly optimal by exhaustive enumeration on
small matrices, and that the memory model is byte-exact against the
packed format.
"""

import itertools

import numpy as np
import scipy.sparse as sp

from corpus import load_corpus
from vbcs_tpu import (
    CSC,
    AffineConnectivityModel,
    ConstrainedCost,
    DynamicTotalChunker,
    SplitPartition,
    VertexCount,
    model_1dvbc_blocks,
    model_1dvbc_memory,
    model_vbc_blocks,
    model_vbc_memory,
    pack_stripe,
    row_component_value,
    total_value,
    vbc1d,
    vbc2d,
)

CORPUS = load_corpus()


def brute_force_best(A: CSC, model, W: int) -> float:
    """Enumerate every partition with widths <= W; return min total cost."""
    n = A.n
    best = np.inf
    # compositions of n into parts <= W
    def rec(start, spl):
        nonlocal best
        if start == n:
            cost = total_value(A, SplitPartition(np.array(spl + [n])), model)
            best = min(best, cost)
            return
        for w in range(1, min(W, n - start) + 1):
            rec(start + w, spl + [start])

    # rec appends split starts; adjust: spl holds starts, final adds n
    def rec2(start, spl):
        nonlocal best
        if start == n:
            cost = total_value(A, SplitPartition(np.array(spl, dtype=np.int64)), model)
            best = min(best, cost)
            return
        for w in range(1, min(W, n - start) + 1):
            rec2(start + w, spl + [start + w])

    rec2(0, [0])
    return best


def test_dp_optimal_small():
    rng = np.random.default_rng(5)
    for trial in range(6):
        m, n = rng.integers(3, 9), rng.integers(3, 9)
        A = CSC.from_scipy(sp.random(int(m), int(n), 0.4, random_state=int(rng.integers(2**31))))
        for model in [
            model_1dvbc_blocks(),
            model_1dvbc_memory(8, 8),
            AffineConnectivityModel(2.0, 0.5, 0.25, 1.0),
        ]:
            W = 3
            Phi = DynamicTotalChunker(model, W).partition(A)
            got = total_value(A, Phi, model)
            want = brute_force_best(A, model, W)
            assert np.isclose(got, want), (trial, type(model).__name__, got, want)
            assert Phi.max_width() <= W


def test_dp_beats_heuristics_on_corpus():
    """The DP minimum must be <= any heuristic partition's cost."""
    from vbcs_tpu import EquiChunker, OverlapChunker, StrictChunker

    for name in ["LPnetlib/lpi_itest6", "HB/west0132", "LPnetlib/lp_blend"]:
        A = CSC.from_scipy(CORPUS[name])
        for model in [model_1dvbc_blocks(), model_1dvbc_memory(8, 8)]:
            W = 8
            Phi_dp = DynamicTotalChunker(model, W).partition(A)
            c_dp = total_value(A, Phi_dp, model)
            for heur in [StrictChunker(W), OverlapChunker(0.9, W), EquiChunker(4)]:
                c_h = total_value(A, heur.partition(A), model)
                assert c_dp <= c_h + 1e-9, (name, type(model).__name__, c_dp, c_h)


def test_memory_model_byte_exact_1d():
    """Min-memory model total == actual packed bytes (modulo the three
    +1 sentinel entries of Phi/pos/ofs), for int64 idx + float64 val."""
    for name, A_sp in CORPUS.items():
        if A_sp.dtype != np.float64:
            continue
        A = CSC.from_scipy(A_sp)
        model = model_1dvbc_memory(8, 8)
        Phi = DynamicTotalChunker(model, 8).partition(A)
        B = vbc1d(A, 8, Phi)
        assert total_value(A, Phi, model) + 3 * 8 == B.memory_bytes()


def test_memory_model_byte_exact_2d():
    for name in ["LPnetlib/lpi_itest6", "LPnetlib/lp_blend"]:
        A = CSC.from_scipy(CORPUS[name])
        model = model_vbc_memory(8, 8)
        B = vbc2d(A, 4, 4)
        got = (
            total_value(A, B.Phi, model, Pi=B.Pi)
            + row_component_value(B.Pi, model)
        )
        # sentinels: Pi, Phi, pos, ofs each have one extra entry vs model
        assert got + 4 * 8 == B.memory_bytes()


def test_blocks_model_counts_blocks():
    for name, A_sp in CORPUS.items():
        A = CSC.from_scipy(A_sp)
        Phi = pack_stripe(A, DynamicTotalChunker(model_1dvbc_blocks(), 4))
        B = vbc1d(A, 4, Phi)
        assert total_value(A, Phi, model_1dvbc_blocks()) == B.num_blocks
        B2 = vbc2d(A, 4, 4)
        assert (
            total_value(A, B2.Phi, model_vbc_blocks(), Pi=B2.Pi) == B2.num_blocks
        )


def test_constrained_cost_cap():
    A = CSC.from_scipy(CORPUS["HB/west0132"])
    c = DynamicTotalChunker(
        ConstrainedCost(model_1dvbc_memory(8, 8), VertexCount(), 3)
    )
    Phi = c.partition(A)
    assert Phi.max_width() <= 3


def test_dp_gamma_group_term():
    """gamma_col (per-8-block-group term, an extension of the reference): the DP must
    charge ceil(nb/8)*gamma(w) and rank plans accordingly, and
    total_value must agree with the DP's objective."""
    import scipy.sparse as sp

    from vbcs_tpu.api import vbc1d
    from vbcs_tpu.formats.csc import CSC
    from vbcs_tpu.models.cost import (ColumnBlockComponentCostModel,
                                      total_value)
    from vbcs_tpu.plan.dynamic import DynamicTotalChunker

    # 8-column blocks, 26 distinct rows each (4 groups at w=8, 1-2 at
    # w<=2): with a large gamma, splitting into narrow stripes is
    # cheaper even though it doubles the stripe count
    rng = np.random.default_rng(0)
    Lb, m = 64, 64 * 8
    rows = []
    cols = []
    for b in range(Lb):
        rr = rng.choice(m, size=26, replace=False)
        for j in range(8):
            rows.extend(rr)
            cols.extend([8 * b + j] * 26)
    A = CSC.from_scipy(sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)),
        shape=(m, m)).tocsc())

    mdl_flat = ColumnBlockComponentCostModel(
        alpha_col=1.0, beta_col=0.01)
    mdl_grp = ColumnBlockComponentCostModel(
        alpha_col=1.0, beta_col=0.01,
        gamma_col=np.array([0.1, 0.1, 0.1, 0.1, 100.0, 100.0, 100.0,
                            100.0]))
    Phi_flat = DynamicTotalChunker(mdl_flat, 8).partition(A)
    Phi_grp = DynamicTotalChunker(mdl_grp, 8).partition(A)
    # flat model: wide stripes amortize alpha; gamma model: width >= 5
    # costs 100 per EXCESS group -> must stay narrow
    assert Phi_flat.widths().max() == 8
    assert Phi_grp.widths().max() <= 4
    # DP optimality vs the evaluator: the chosen plan's total_value
    # must not exceed the flat plan's under the gamma model
    assert (total_value(A, Phi_grp, mdl_grp)
            <= total_value(A, Phi_flat, mdl_grp) + 1e-9)
    # stripe_cost includes the group term
    c = mdl_grp.stripe_cost(8, 26)
    assert abs(c - (1.0 + 26 * 0.01 + 3 * 100.0)) < 1e-9
