"""Multi-device VBC SpMV/SpMM over a `jax.sharding.Mesh`.

The reference's only parallelism is shared-memory dynamic stripe
scheduling (`src/multiply_1DVBC.jl:169-177`).  Here that becomes SPMD
over a device mesh:

* the *block streams* of every width class are partitioned contiguously
  across devices (blocks are stored stripe-ordered, so each shard owns a
  contiguous stripe range — the moral equivalent of the reference's
  stripe scheduling, but statically balanced by block count);
* `x` is replicated (a halo-exchange variant is planned — stripes only
  read the `x[idx]` rows their blocks touch);
* each device computes its partial `y` by the same gather → multiply →
  segment-sum → scatter pipeline, and partials combine with a single
  `psum` (stripe outputs are disjoint, so the sum merely superimposes
  disjoint slices plus zeros).

Everything is `shard_map`-ped and jit-compiled; XLA hands the
collectives to the device's collective library (NCCL on GPUs).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.device import VBC1DClass, VBC1DDevice, VBC2DClass, VBC2DDevice
from ..ops import xla as xla_ops

__all__ = ["shard_vbc", "dist_tr_spmv", "dist_spmv", "dist_tr_spmm", "dist_spmm"]


def _pad_blocks_to(c, multiple: int):
    """Pad a class's block axis to a multiple (pad blocks are inert:
    zero val, seg == num_stripes => dropped segment)."""
    Q = c.val.shape[0]
    Qp = -(-Q // multiple) * multiple
    if Qp == Q:
        return c
    pad = Qp - Q
    val = np.zeros((Qp,) + c.val.shape[1:], dtype=c.val.dtype)
    val[:Q] = np.asarray(c.val)
    seg = np.full(Qp, c.num_stripes, dtype=np.int32)
    seg[:Q] = np.asarray(c.seg)
    if isinstance(c, VBC1DClass):
        row = np.zeros(Qp, dtype=np.int32)
        row[:Q] = np.asarray(c.row)
        return VBC1DClass(
            w=c.w, num_stripes=c.num_stripes, val=val, row=row, seg=seg, ycol=c.ycol
        )
    rowstart = np.zeros(Qp, dtype=np.int32)
    rowstart[:Q] = np.asarray(c.rowstart)
    return VBC2DClass(
        u=c.u,
        w=c.w,
        num_stripes=c.num_stripes,
        val=val,
        rowstart=rowstart,
        seg=seg,
        ycol=c.ycol,
    )


def block_specs(dev, axis: str | None):
    """PartitionSpec pytree for a device format: block arrays sharded on
    the mesh axis, per-stripe metadata replicated."""
    def class_spec(c):
        blocked = P(axis) if axis else P()
        kw = dict(val=blocked, seg=blocked, ycol=P())
        if isinstance(c, VBC1DClass):
            return VBC1DClass(
                w=c.w, num_stripes=c.num_stripes, row=blocked, **kw
            )
        return VBC2DClass(
            u=c.u, w=c.w, num_stripes=c.num_stripes, rowstart=blocked, **kw
        )

    cls = tuple(class_spec(c) for c in dev.classes)
    if isinstance(dev, VBC1DDevice):
        return VBC1DDevice(m=dev.m, n=dev.n, dtype_name=dev.dtype_name, classes=cls)
    return VBC2DDevice(m=dev.m, n=dev.n, dtype_name=dev.dtype_name, classes=cls)


def shard_vbc(dev, mesh: Mesh, axis: str = "d"):
    """Pad + place a device format sharded over ``mesh``'s ``axis``."""
    ndev = mesh.shape[axis]
    cls = tuple(_pad_blocks_to(c, ndev * 8) for c in dev.classes)
    if isinstance(dev, VBC1DDevice):
        dev = VBC1DDevice(
            m=dev.m, n=dev.n, dtype_name=dev.dtype_name, classes=cls
        )
    else:
        dev = VBC2DDevice(
            m=dev.m, n=dev.n, dtype_name=dev.dtype_name, classes=cls
        )
    specs = block_specs(dev, axis)
    shardings = jax.tree.map(
        lambda s: NamedSharding(mesh, s),
        specs,
        is_leaf=lambda x: isinstance(x, P),
    )
    return jax.device_put(dev, shardings)


def _dist_call(kernel, dev, x, mesh: Mesh, axis: str):
    """shard_map a single-device kernel: block-sharded A, replicated x,
    psum-combined output."""

    def local(dev_shard, x_rep):
        y = kernel(dev_shard, x_rep)
        return jax.lax.psum(y, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(block_specs(dev, axis), P()),
        out_specs=P(),
    )(dev, x)


def dist_tr_spmv(dev, x, mesh: Mesh, axis: str = "d"):
    """y = A.T @ x across the mesh."""
    return _dist_call(xla_ops.tr_spmv, dev, x, mesh, axis)


def dist_spmv(dev, x, mesh: Mesh, axis: str = "d"):
    """y = A @ x across the mesh."""
    return _dist_call(xla_ops.spmv, dev, x, mesh, axis)


def dist_tr_spmm(dev, X, mesh: Mesh, axis: str = "d"):
    """Y = A.T @ X across the mesh (dense RHS replicated)."""
    return _dist_call(xla_ops.tr_spmm, dev, X, mesh, axis)


def dist_spmm(dev, X, mesh: Mesh, axis: str = "d"):
    """Y = A @ X across the mesh."""
    return _dist_call(xla_ops.spmm, dev, X, mesh, axis)
