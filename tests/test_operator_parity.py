"""Operator parity on the XLA device path against scipy (float64), over
the matrix families in ``families.py`` x every operator call."""

import jax.numpy as jnp
import numpy as np
import pytest

from families import BUILDERS, family

RTOL, ATOL = 1e-10, 1e-10


def _rhs(n, seed, k=None):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(n if k is None else (n, k))


def _close(got, want):
    got = np.asarray(got)
    assert got.shape == want.shape
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def op_tr_mul(A, op):
    x = _rhs(A.shape[0], 1)
    _close(op.tr_mul(jnp.asarray(x)), A.T @ x)


def op_mul(A, op):
    x = _rhs(A.shape[1], 2)
    _close(op.mul(jnp.asarray(x)), A @ x)


def op_alpha_beta_y(A, op):
    x, y = _rhs(A.shape[0], 3), _rhs(A.shape[1], 4)
    _close(op.tr_mul(jnp.asarray(x), alpha=1.5, beta=-0.5, y=jnp.asarray(y)),
           1.5 * (A.T @ x) - 0.5 * y)
    xf, yf = _rhs(A.shape[1], 5), _rhs(A.shape[0], 6)
    _close(op.mul(jnp.asarray(xf), alpha=2.0, beta=0.25, y=jnp.asarray(yf)),
           2.0 * (A @ xf) + 0.25 * yf)


def op_tr_mul_mat(A, op):
    X = _rhs(A.shape[0], 7, k=5)
    _close(op.tr_mul_mat(jnp.asarray(X)), A.T @ X)


def op_mul_mat(A, op):
    X = _rhs(A.shape[1], 8, k=3)
    _close(op.mul_mat(jnp.asarray(X)), A @ X)


def op_tr_mul_chain(A, op):
    x = _rhs(A.shape[0], 9)
    if A.shape[0] != A.shape[1]:
        with pytest.raises(ValueError, match="square"):
            op.tr_mul_chain(jnp.asarray(x), 3, 0.5)
        return
    want = x
    for _ in range(3):
        want = 0.5 * (A.T @ want)
    _close(op.tr_mul_chain(jnp.asarray(x), 3, 0.5), want)


OPS = [op_tr_mul, op_mul, op_alpha_beta_y, op_tr_mul_mat, op_mul_mat,
       op_tr_mul_chain]


@pytest.mark.parametrize("op_case", OPS, ids=lambda f: f.__name__[3:])
@pytest.mark.parametrize("name", list(BUILDERS))
def test_operator_matches_scipy(name, op_case):
    A, op = family(name)
    op_case(A, op)
