"""Autotuned time-model fit pipeline (reference ``src/costs.jl:12-136``
for 1-D, ``:249-290`` for 2-D).

The on-device measurement is injected with a synthetic ground-truth time
law so the LSQ fit, monotonization, and rank-R SVD factorization are
exercised CPU-only; the device measurement path runs here on the CPU
at a tiny size (``test_measure_times_the_routed_kernel``) and on the
GPU through ``bench_tools/test_table.py``.
"""

import numpy as np
import pytest

from vbcs_tpu.models import autotune as at
from vbcs_tpu.models.cost import (
    BlockComponentCostModel,
    ColumnBlockComponentCostModel,
    component_at,
)

W, U = 3, 2

# ground-truth per-size tables (ns units)
ALPHA_COL = np.array([10.0, 12.0, 15.0])
BETA_COL = np.array([2.0, 3.0, 5.0])
ALPHA_ROW2 = np.array([4.0, 6.0])
ALPHA_COL2 = np.array([8.0, 9.0, 11.0])
BETA_GRID = np.array([[1.0, 2.0, 3.0], [1.5, 3.5, 6.0]])  # [U, W]


def measure_1d(B, w):
    L = len(B.Phi)
    q = B.num_blocks
    t_ns = 0.01 * B.m + ALPHA_COL[w - 1] * L + BETA_COL[w - 1] * q
    return t_ns * 1e-9


def measure_2d(B2, u, w):
    K, L, q = len(B2.Pi), len(B2.Phi), B2.num_blocks
    t_ns = (
        ALPHA_ROW2[u - 1] * K
        + ALPHA_COL2[w - 1] * L
        + BETA_GRID[u - 1, w - 1] * q
    )
    return t_ns * 1e-9


def test_autotune_1d_recovers_law():
    alpha, beta, gamma = at.autotune_1dvbc_trspmv(
        W=W,
        d=4,
        target_bytes=1 << 18,
        band=64,
        cache=False,
        measure=measure_1d,
    )
    # the fit sees an extra m-term; per-width tables should still land
    # close to the ground truth (same design family)
    assert np.all(np.diff(alpha) >= -1e-9)  # monotone
    assert np.all(np.diff(beta) >= -1e-9)
    np.testing.assert_allclose(beta, BETA_COL, rtol=0.2)


def test_autotune_2d_recovers_law_and_svd():
    alpha_row, alpha_col, beta_row, beta_col = at.autotune_vbc_trspmv(
        U=U,
        W=W,
        d=4,
        target_bytes=1 << 18,
        band=64,
        rank=2,
        cache=False,
        measure=measure_2d,
    )
    assert alpha_row.shape == (U,) and alpha_col.shape == (W,)
    assert len(beta_row) == len(beta_col) == 2
    # monotone along both axes
    assert np.all(np.diff(alpha_row) >= -1e-9)
    assert np.all(np.diff(alpha_col) >= -1e-9)
    # rank-2 SVD of a 2x3 grid is exact: reconstruct and compare
    recon = sum(np.outer(br, bc) for br, bc in zip(beta_row, beta_col))
    np.testing.assert_allclose(recon, BETA_GRID, rtol=0.25, atol=0.3)
    np.testing.assert_allclose(alpha_row, ALPHA_ROW2, rtol=0.3, atol=1.0)


def test_model_constructors_wrap_tables():
    m1 = ColumnBlockComponentCostModel(
        alpha_col=ALPHA_COL, beta_col=BETA_COL
    )
    assert m1.stripe_cost(2, 10) == ALPHA_COL[1] + 10 * BETA_COL[1]
    m2 = BlockComponentCostModel(
        alpha_row=ALPHA_ROW2,
        alpha_col=ALPHA_COL2,
        beta_row=(BETA_GRID[:, 0],),
        beta_col=(np.array([1.0, 2.0, 3.0]),),
    )
    assert m2.block_cost(2, 3) == BETA_GRID[1, 0] * 3.0
    assert component_at(m2.alpha_row, 1) == ALPHA_ROW2[0]


def test_model_vbc_trspmv_time_builds(monkeypatch):
    monkeypatch.setattr(
        at,
        "autotune_vbc_trspmv",
        lambda U=2, W=3, **kw: (
            ALPHA_ROW2,
            ALPHA_COL2,
            (BETA_GRID[:, 0],),
            (np.array([1.0, 2.0, 3.0]),),
        ),
    )
    mdl = at.model_vbc_trspmv_time(U, W)
    assert isinstance(mdl, BlockComponentCostModel)
    assert mdl.rank == 1


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_measure_times_the_routed_kernel(kind):
    """The fit's measurement runs operator.route_tr_spmv's kernel."""
    from vbcs_tpu.formats.csc import CSC
    from vbcs_tpu.formats.partition import SplitPartition
    from vbcs_tpu.formats.vbc1d import pack_1dvbc
    from vbcs_tpu.formats.vbc2d import pack_vbc2d

    C = CSC.from_scipy(at._synth(64, 4, 3, 16, seed=1))
    if kind == "1d":
        B = pack_1dvbc(C, SplitPartition.equi(C.n, 4), 4)
    else:
        B = pack_vbc2d(C, SplitPartition.equi(C.m, 2),
                       SplitPartition.equi(C.n, 4), 2, 4)
    t, kname = at._measure_routed(B, reps=2)
    assert kname == "xla" and t > 0
