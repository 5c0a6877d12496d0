"""XLA (jnp) compute kernels for the device VBC formats.

These are the device kernels of every operator call: gather -> multiply
-> segment-sum -> scatter, one instance per static size class.  They are
the re-design of the reference's SIMD kernels (``src/multiply_1DVBC.jl``,
``src/multiply_VBC.jl``):

* the reference's per-stripe ``Vec{w}`` accumulator loop becomes a
  class-wide segmented sum over the block axis;
* the forward kernel's scatter (which forced the reference sequential,
  ``multiply_1DVBC.jl:30-37``) becomes an XLA scatter-add — parallel;
  on a GPU it lowers to atomics, so the order of the few (< 64) terms
  of each output varies from run to run;
* zero-padded class lanes reproduce the reference's tail-fill trick, so
  padded entries contribute exact 0.0.

Every float contraction asks for ``Precision.HIGHEST``: a GPU would
otherwise compute f32 products in TF32 (about three decimal digits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.device import VBC1DDevice, VBC2DDevice

__all__ = ["tr_spmv", "spmv", "tr_spmm", "spmm"]

_HI = jax.lax.Precision.HIGHEST


def _seg_sum(prod, seg, num_segments):
    """Segment-sum dropping the padding segment (id == num_segments)."""
    return jax.ops.segment_sum(prod, seg, num_segments=num_segments + 1)[
        :num_segments
    ]


def tr_spmv(A: VBC1DDevice | VBC2DDevice, x: jax.Array) -> jax.Array:
    """y = A.T @ x (TrSpMV — the paper's hot op).

    Per class: gather x at block rows, multiply into the padded block
    values, segment-sum per stripe, scatter each stripe's w-slice into
    its disjoint y range (race-free by construction, mirroring the
    reference's per-stripe output slices ``multiply_1DVBC.jl:171-176``).
    """
    y = jnp.zeros(A.n, dtype=x.dtype)
    for c in A.classes:
        if hasattr(c, "row"):  # 1-D class
            xg = x[c.row]  # [Q]
            prod = c.val.astype(x.dtype) * xg[:, None]  # [Q, w]
        else:  # 2-D class: gather u rows of x per block
            ridx = c.rowstart[:, None] + jnp.arange(c.u, dtype=jnp.int32)[None, :]
            xg = jnp.take(x, ridx, mode="fill", fill_value=0)  # [Q, u]
            prod = jnp.einsum(
                "quw,qu->qw", c.val.astype(x.dtype), xg, precision=_HI
            )  # [Q, w]
        ys = _seg_sum(prod, c.seg, c.num_stripes)  # [L, w]
        cols = c.ycol[:, None] + jnp.arange(c.w, dtype=jnp.int32)[None, :]
        y = y.at[cols.reshape(-1)].add(ys.reshape(-1), mode="drop")
    return y


def spmv(A: VBC1DDevice | VBC2DDevice, x: jax.Array) -> jax.Array:
    """y = A @ x (forward / scatter SpMV)."""
    y = jnp.zeros(A.m, dtype=x.dtype)
    for c in A.classes:
        cols = c.ycol[:, None] + jnp.arange(c.w, dtype=jnp.int32)[None, :]
        xw = jnp.take(x, cols, mode="fill", fill_value=0)  # [L, w]
        xw = jnp.concatenate(
            [xw, jnp.zeros((1, c.w), dtype=x.dtype)], axis=0
        )  # pad segment row
        xb = xw[c.seg]  # [Q, w]
        if hasattr(c, "row"):  # 1-D
            contrib = (c.val.astype(x.dtype) * xb).sum(axis=1)  # [Q]
            y = y.at[c.row].add(contrib, mode="drop")
        else:  # 2-D
            contrib = jnp.einsum(
                "quw,qw->qu", c.val.astype(x.dtype), xb, precision=_HI
            )
            ridx = c.rowstart[:, None] + jnp.arange(c.u, dtype=jnp.int32)[None, :]
            y = y.at[ridx.reshape(-1)].add(contrib.reshape(-1), mode="drop")
    return y


def tr_spmm(A: VBC1DDevice | VBC2DDevice, X: jax.Array) -> jax.Array:
    """Y = A.T @ X for dense RHS X [m, k] (SpMM, reuses block panels)."""
    k = X.shape[1]
    Y = jnp.zeros((A.n, k), dtype=X.dtype)
    for c in A.classes:
        if hasattr(c, "row"):
            Xg = X[c.row]  # [Q, k]
            prod = jnp.einsum(
                "qw,qk->qwk", c.val.astype(X.dtype), Xg, precision=_HI
            )
        else:
            ridx = c.rowstart[:, None] + jnp.arange(c.u, dtype=jnp.int32)[None, :]
            Xg = jnp.take(X, ridx, axis=0, mode="fill", fill_value=0)  # [Q, u, k]
            prod = jnp.einsum(
                "quw,quk->qwk", c.val.astype(X.dtype), Xg, precision=_HI
            )
        ys = _seg_sum(prod, c.seg, c.num_stripes)  # [L, w, k]
        cols = c.ycol[:, None] + jnp.arange(c.w, dtype=jnp.int32)[None, :]
        Y = Y.at[cols.reshape(-1)].add(
            ys.reshape(-1, k), mode="drop"
        )
    return Y


def spmm(A: VBC1DDevice | VBC2DDevice, X: jax.Array) -> jax.Array:
    """Y = A @ X for dense RHS X [n, k]."""
    k = X.shape[1]
    Y = jnp.zeros((A.m, k), dtype=X.dtype)
    for c in A.classes:
        cols = c.ycol[:, None] + jnp.arange(c.w, dtype=jnp.int32)[None, :]
        Xw = jnp.take(X, cols, axis=0, mode="fill", fill_value=0)  # [L, w, k]
        Xw = jnp.concatenate(
            [Xw, jnp.zeros((1, c.w, k), dtype=X.dtype)], axis=0
        )
        Xb = Xw[c.seg]  # [Q, w, k]
        if hasattr(c, "row"):
            contrib = jnp.einsum(
                "qw,qwk->qk", c.val.astype(X.dtype), Xb, precision=_HI
            )
            Y = Y.at[c.row].add(contrib, mode="drop")
        else:
            contrib = jnp.einsum(
                "quw,qwk->quk", c.val.astype(X.dtype), Xb, precision=_HI
            )
            ridx = c.rowstart[:, None] + jnp.arange(c.u, dtype=jnp.int32)[None, :]
            Y = Y.at[ridx.reshape(-1)].add(
                contrib.reshape(-1, k), mode="drop"
            )
    return Y
