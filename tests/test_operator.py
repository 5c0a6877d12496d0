"""VBCOperator API (the XLA device path, here on the CPU) and row
reordering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from corpus import load_corpus
from vbcs_tpu import CSC
from vbcs_tpu.operator import VBCOperator
from vbcs_tpu.plan.reorder import profile_rows, rcm_rows

CORPUS = load_corpus()


def test_operator_both_directions():
    A = CORPUS["LPnetlib/lp_blend"].astype(np.float64)
    op = VBCOperator.from_csc(A, W=4)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(A.shape[0])
    xf = rng.standard_normal(A.shape[1])
    np.testing.assert_allclose(
        np.asarray(op.tr_mul(jnp.asarray(x))), A.T @ x, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(op.mul(jnp.asarray(xf))), A @ xf, rtol=1e-5, atol=1e-5
    )
    # host oracles agree
    np.testing.assert_allclose(op.host_tr_mul(x), A.T @ x, rtol=1e-12)
    np.testing.assert_allclose(op.host_mul(xf), A @ xf, rtol=1e-12)
    assert op.memory_bytes() > 0


def test_operator_spmm():
    A = CORPUS["LPnetlib/lpi_itest6"].astype(np.float64)
    op = VBCOperator.from_csc(A, W=4)
    rng = np.random.default_rng(1)
    X = rng.standard_normal((A.shape[0], 5))
    Xf = rng.standard_normal((A.shape[1], 5))
    np.testing.assert_allclose(
        np.asarray(op.tr_mul_mat(jnp.asarray(X))), A.T @ X, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(op.mul_mat(jnp.asarray(Xf))), A @ Xf, rtol=1e-5, atol=1e-5
    )


def test_operator_single_direction_errors():
    A = CORPUS["LPnetlib/lpi_itest6"]
    op = VBCOperator.from_csc(A, W=4, directions="transposed")
    try:
        op.mul(jnp.zeros(A.shape[1]))
        assert False, "expected ValueError"
    except ValueError:
        pass


def test_profile_rows_reduces_bandwidth():
    rng = np.random.default_rng(2)
    n = 400
    perm0 = rng.permutation(n)
    # banded matrix scrambled by a random row permutation
    diags = sp.diags(
        [np.ones(n - d) for d in range(4)], offsets=list(range(4)), shape=(n, n)
    ).tocsc()
    A = CSC.from_scipy(diags[perm0, :])

    def bandwidth(C):
        S = C.to_scipy().tocoo()
        return int(np.abs(S.row - S.col).max())

    B, perm = profile_rows(A)
    assert bandwidth(B) < bandwidth(A) / 4
    # semantics: A.T @ x == B.T @ x[perm]
    x = rng.standard_normal(n)
    np.testing.assert_allclose(
        A.to_scipy().T @ x, B.to_scipy().T @ x[perm], rtol=1e-12
    )


def test_rcm_rows_semantics():
    A = CSC.from_scipy(CORPUS["HB/can_292"].astype(np.float64))
    B, perm = rcm_rows(A)
    x = np.random.default_rng(4).standard_normal(A.m)
    np.testing.assert_allclose(
        A.to_scipy().T @ x, B.to_scipy().T @ x[perm], rtol=1e-12
    )


def test_profile_rows_rectangular():
    A = CSC.from_scipy(CORPUS["LPnetlib/lp_etamacro"])
    B, perm = profile_rows(A)
    x = np.random.default_rng(3).standard_normal(A.m)
    np.testing.assert_allclose(
        A.to_scipy().T @ x, B.to_scipy().T @ x[perm], rtol=1e-12
    )


def test_alpha_beta_device():
    """Device-side alpha/beta (reference mul!(y,A,x,alpha,beta); alpha
    applied correctly — deliberate fix of the reference quirk)."""
    A = sp.random(60, 80, 0.1, random_state=9, format="csc")
    op = VBCOperator.from_csc(A, W=4)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal(60), jnp.float32)
    y0 = jnp.asarray(rng.standard_normal(80), jnp.float32)
    got = np.asarray(op.tr_mul(x, alpha=2.0, beta=-0.5, y=y0))
    want = 2.0 * (A.T @ np.asarray(x, np.float64)) - 0.5 * np.asarray(
        y0, np.float64
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    z = jnp.asarray(rng.standard_normal(80), jnp.float32)
    got2 = np.asarray(op.mul(z, alpha=3.0))
    np.testing.assert_allclose(
        got2, 3.0 * (A @ np.asarray(z, np.float64)), rtol=1e-4, atol=1e-4
    )


def test_operator_2d_both_directions():
    A = CORPUS["LPnetlib/lp_blend"].astype(np.float64)
    from vbcs_tpu.operator import VBC2DOperator

    op = VBC2DOperator.from_csc(A, U=4, W=4)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.shape[0])
    xf = rng.standard_normal(A.shape[1])
    np.testing.assert_allclose(
        np.asarray(op.tr_mul(jnp.asarray(x))), A.T @ x, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(op.mul(jnp.asarray(xf))), A @ xf, rtol=1e-5, atol=1e-5
    )
    X = rng.standard_normal((A.shape[0], 6))
    Xf = rng.standard_normal((A.shape[1], 6))
    np.testing.assert_allclose(
        np.asarray(op.tr_mul_mat(jnp.asarray(X))), A.T @ X, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(op.mul_mat(jnp.asarray(Xf))), A @ Xf, rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(op.host_tr_mul(x), A.T @ x, rtol=1e-12)
    np.testing.assert_allclose(op.host_mul(xf), A @ xf, rtol=1e-12)
    assert op.memory_bytes() > 0
    # alpha/beta applied (reference ignores alpha — documented quirk, fixed)
    y0 = rng.standard_normal(A.shape[1])
    got = np.asarray(op.tr_mul(jnp.asarray(x), alpha=2.0, beta=0.5,
                               y=jnp.asarray(y0)))
    np.testing.assert_allclose(got, 2.0 * (A.T @ x) + 0.5 * y0,
                               rtol=1e-5, atol=1e-5)


def test_operator_fp64_basis_parity():
    """Config-1 contract: fp64 bitwise parity vs the dense oracle on
    basis vectors, THROUGH the operator's device path (the XLA device
    kernels run the matrix's own dtype — reference runs Float64,
    test/runtests.jl:15)."""
    A = CORPUS["LPnetlib/lpi_itest6"].astype(np.float64)
    op = VBCOperator.from_csc(A, W=4)
    Ad = A.toarray()
    for i in range(A.shape[0]):
        e = np.zeros(A.shape[0])
        e[i] = 1.0
        y = np.asarray(op.tr_mul(jnp.asarray(e)))
        assert y.dtype == np.float64
        np.testing.assert_array_equal(y, Ad[i, :])
    for j in range(A.shape[1]):
        e = np.zeros(A.shape[1])
        e[j] = 1.0
        y = np.asarray(op.mul(jnp.asarray(e)))
        np.testing.assert_array_equal(y, Ad[:, j])


def test_operator_bool_int_semirings():
    """Bool and Int32 matrices execute on device in their own dtype
    (reference src/hacks.jl:1 Bool shim + Int32 tests)."""
    rng = np.random.default_rng(3)
    dense = (rng.random((40, 30)) < 0.2)
    Ab = sp.csc_matrix(dense)
    op = VBCOperator.from_csc(Ab, W=4)
    x = rng.standard_normal(40)
    got = np.asarray(op.tr_mul(jnp.asarray(x)))
    np.testing.assert_allclose(got, dense.astype(np.float64).T @ x,
                               rtol=1e-12, atol=1e-12)
    Ai = sp.csc_matrix((dense * rng.integers(1, 9, dense.shape)).astype(np.int32))
    opi = VBCOperator.from_csc(Ai, W=4)
    xi = rng.integers(-5, 5, 40).astype(np.int32)
    got_i = np.asarray(opi.tr_mul(jnp.asarray(xi)))
    assert got_i.dtype in (np.int32, np.int64)
    np.testing.assert_array_equal(got_i, (Ai.toarray().astype(np.int64).T
                                          @ xi.astype(np.int64)).astype(got_i.dtype))


def _grid_laplacian(k, seed=0, scramble=True):
    """k*k 5-point grid Laplacian, rows/cols randomly relabeled
    (thermal1-like FEM structure hidden behind a bad ordering)."""
    n = k * k
    ii, jj, vv = [], [], []
    for r in range(k):
        for c in range(k):
            u = r * k + c
            ii.append(u); jj.append(u); vv.append(4.0)
            for dr, dc in ((0, 1), (1, 0)):
                r2, c2 = r + dr, c + dc
                if r2 < k and c2 < k:
                    v2 = r2 * k + c2
                    ii += [u, v2]; jj += [v2, u]; vv += [-1.0, -1.0]
    A = sp.coo_matrix((vv, (ii, jj)), shape=(n, n)).tocsc()
    if scramble:
        rng = np.random.default_rng(seed)
        p = rng.permutation(n)
        A = A[p][:, p].tocsc()
    return A


def test_auto_rcm_reorder():
    """A scrambled FEM matrix triggers the auto symmetric-RCM path and
    still matches the oracle (reference analog: the planner choosing
    well on thermal1-like structure, BASELINE.md:77)."""
    A = _grid_laplacian(40)  # 1600 > the 1024 auto threshold
    op = VBCOperator.from_csc(A, W=4, reorder="always")
    assert op.row_perm is not None
    from vbcs_tpu.plan.reorder import window_badness
    assert window_badness(op.host_tr) <= window_badness(
        VBCOperator.from_csc(A, W=4,
                             reorder="never").host_tr)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(A.shape[0]).astype(np.float32)
    got = np.asarray(op.tr_mul(jnp.asarray(x)))
    want = (A.T @ x).astype(np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    got_f = np.asarray(op.mul(jnp.asarray(x)))
    np.testing.assert_allclose(got_f, (A @ x).astype(np.float32),
                               rtol=2e-4, atol=2e-4)
    # chained: one jitted loop, boundary perms once per call
    got_c = np.asarray(op.tr_mul_chain(jnp.asarray(x), 2, 0.5))
    want_c = 0.5 * (A.T @ (0.5 * (A.T @ x.astype(np.float64))))
    np.testing.assert_allclose(got_c, want_c.astype(np.float32),
                               rtol=2e-4, atol=2e-4)


def test_auto_rcm_mul_mat():
    """mul_mat / tr_mul_mat apply the auto-RCM boundary permutations
    (round-2 advisor finding: mul_mat returned permuted-row output)."""
    A = _grid_laplacian(40)
    op = VBCOperator.from_csc(A, W=4, reorder="always")
    assert op.row_perm is not None
    rng = np.random.default_rng(7)
    X = rng.standard_normal((A.shape[1], 3)).astype(np.float32)
    got = np.asarray(op.mul_mat(jnp.asarray(X)))
    np.testing.assert_allclose(got, (A @ X).astype(np.float32),
                               rtol=2e-4, atol=2e-4)
    got_t = np.asarray(op.tr_mul_mat(jnp.asarray(X)))
    np.testing.assert_allclose(got_t, (A.T @ X).astype(np.float32),
                               rtol=2e-4, atol=2e-4)


def test_chain_dtype_and_zero_iters():
    """tr_mul_chain stays dtype-correct (f64 never silently downcast)
    and n_iters=0 returns x unchanged."""
    A = CORPUS["HB/can_292"].astype(np.float64)
    op = VBCOperator.from_csc(A, W=4)
    x = np.random.default_rng(2).standard_normal(A.shape[0])
    out = np.asarray(op.tr_mul_chain(jnp.asarray(x), 2))
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, A.T @ (A.T @ x), rtol=1e-10, atol=1e-10)
    out0 = np.asarray(op.tr_mul_chain(jnp.asarray(x), 0))
    np.testing.assert_array_equal(out0, x)


@pytest.mark.parametrize("kind", ["1d", "2d"])
def test_route_tr_spmv_is_the_operator_path(kind):
    """operator.route_tr_spmv is the one routing function: the operator's
    device format is the routed one, and the routed call computes
    A.T @ x for both packed formats."""
    from vbcs_tpu.formats.device import VBC1DDevice, VBC2DDevice
    from vbcs_tpu.operator import VBC2DOperator, route_tr_spmv
    from vbcs_tpu.ops import xla

    A = CORPUS["LPnetlib/lp_blend"].astype(np.float64)
    if kind == "1d":
        op = VBCOperator.from_csc(A, W=4)
        dev_type = VBC1DDevice
    else:
        op = VBC2DOperator.from_csc(A, U=4, W=4)
        dev_type = VBC2DDevice
    name, fmt, call = route_tr_spmv(op.host_tr)
    assert name == "xla" and call is xla.tr_spmv
    assert isinstance(fmt, dev_type)
    assert isinstance(op.device_format("tr"), dev_type)
    assert jax.tree.structure(fmt) == jax.tree.structure(
        op.device_format("tr"))
    x = np.random.default_rng(5).standard_normal(A.shape[0])
    np.testing.assert_allclose(np.asarray(call(fmt, jnp.asarray(x))),
                               A.T @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(op.tr_mul(jnp.asarray(x))),
                               np.asarray(call(fmt, jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


def test_device_format_is_cached_per_direction():
    A = CORPUS["HB/west0132"].astype(np.float64)
    op = VBCOperator.from_csc(A, W=4)
    assert op.device_format("tr") is op.device_format("tr")
    assert op.device_format("fw") is not op.device_format("tr")
    only_tr = VBCOperator.from_csc(A, W=4, directions="transposed")
    with pytest.raises(ValueError, match="forward"):
        only_tr.device_format("fw")
