"""VBCOperator — the user-facing sparse operator.

Bundles everything a user of the reference library gets from
``SparseMatrix1DVBC`` / ``SparseMatrixVBC`` plus device execution:

* plan (any chunker / DP method) + pack on ingest;
* ``A @ x``, ``A.T @ x``, ``A @ X``, ``A.T @ X`` on the accelerator
  through the XLA kernels of :mod:`vbcs_tpu.ops.xla`, each call one
  jitted executable;
* host NumPy oracles for verification (``.host``);
* memory/cost introspection (``memory_bytes``).

Design notes:

* The *forward* SpMV (a scatter in the reference,
  ``src/multiply_1DVBC.jl:13-83``, which forced its kernel sequential)
  runs as the gather-style kernel on a second pack of ``A.T`` — the two
  directions are two device formats over the same data.  ``directions``
  controls which are materialized.
* Rows can be pre-permuted for locality (see ``plan.reorder``); the
  operator carries the permutation and applies it at the boundaries.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .api import default_1d_partitioner
from .formats.csc import CSC
from .formats.device import bin_vbc1d, bin_vbc2d
from .formats.vbc1d import VBC1D, pack_1dvbc
from .ops import xla
from .plan.alternating import pack_stripe


def route_tr_spmv(B):
    """The device kernel that computes ``B.T @ x`` for a packed host
    format ``B`` (:class:`VBC1D` or :class:`VBC2D`): ``(name, fmt,
    call)`` with ``call(fmt, x) -> y``.

    The one routing function: the operators build their device formats
    through it, ``models/autotune`` fits its time model to it and
    ``bench_tools/test_table`` times it, so all three measure the same
    kernel (the reference's fidelity contract times the same
    ``mul!(y,B',x)`` the autotuner benchmarks, ``src/costs.jl:87-94``
    vs ``bin/test_table.jl:80``)."""
    with jax.ensure_compile_time_eval():
        fmt = bin_vbc1d(B) if isinstance(B, VBC1D) else bin_vbc2d(B)
    return "xla", fmt, xla.tr_spmv


def _axpby(out, alpha, beta, y):
    """alpha*out + beta*y with the defaults (None) compiling to nothing."""
    if alpha is not None:
        out = out * alpha
    if y is not None and beta is not None:
        out = out + beta * y
    return out


@partial(jax.jit, static_argnums=0)
def _apply(kernel, fmt, x, perm, inv, alpha, beta, y):
    """One operator call as one executable: entry permutation, kernel,
    exit permutation, alpha/beta epilogue (``None`` parts vanish)."""
    if perm is not None:
        x = x[perm]
    out = kernel(fmt, x)
    if inv is not None:
        out = out[inv]
    return _axpby(out, alpha, beta, y)


@jax.jit
def _chain(fmt, x, n_iters, perm, inv, alpha):
    """(alpha * A.T)^n_iters @ x; a symmetric relabeling maps permuted
    space to itself, so the boundary permutations are paid once."""
    if perm is not None:
        x = x[perm]

    def body(i, xc):
        out = xla.tr_spmv(fmt, xc)
        return out if alpha is None else out * jnp.asarray(alpha, out.dtype)

    x = jax.lax.fori_loop(0, n_iters, body, x)
    return x if inv is None else x[inv]


def _as_csc(A) -> CSC:
    return A if isinstance(A, CSC) else CSC.from_scipy(A)


@dataclasses.dataclass
class VBCOperator:
    """Sparse matrix operator in 1D-VBC form, device-executable."""

    m: int
    n: int
    host_tr: VBC1D | None  # column-striped A (for A.T @ x)
    host_fw: VBC1D | None  # column-striped A.T (for A @ x)
    row_perm: object = None  # symmetric relabeling (auto-RCM), or None
    _dev: dict = dataclasses.field(default_factory=dict, repr=False,
                                   compare=False)  # lazy device arrays

    # ---- construction ----------------------------------------------------

    @staticmethod
    def from_csc(
        A,
        W: int = 8,
        method=None,
        method_forward=None,
        directions: str = "both",
        reorder: str = "auto",
    ) -> "VBCOperator":
        """Plan + pack ``A`` (and/or ``A.T``) into VBC operators.

        ``directions``: "both" | "transposed" (A.T@x only) | "forward".
        ``method`` plans the columns of A; ``method_forward`` the columns
        of A.T (defaults to ``method``).

        ``reorder``: "auto" applies a *symmetric* RCM relabeling when a
        cheap locality estimate (``plan.reorder.window_badness``) says a
        material share of the block stream gathers x from far-apart rows
        (scattered FEM matrices like Schmid/thermal1 become banded);
        "never"/"always" force it off/on.  The operator carries the
        permutation and applies it at the call boundaries, so chained
        multiplies stay in permuted space.
        """
        A = _as_csc(A)
        method = method or default_1d_partitioner(W, A.val.dtype.itemsize)
        method_forward = method_forward or method

        row_perm = None
        probe_pack = None  # reused as host_tr (same method/W as the probe)
        if reorder in ("auto", "always") and A.m == A.n and A.m > 1024:
            from .plan.reorder import rcm_symmetric, window_badness

            probe_pack = pack_1dvbc(A, pack_stripe(A, method), W)
            bad = window_badness(probe_pack)
            if reorder == "always" or bad > 0.05:
                Ap, perm = rcm_symmetric(A)
                probe_p = pack_1dvbc(Ap, pack_stripe(Ap, method), W)
                if reorder == "always" or window_badness(probe_p) < bad:
                    A, row_perm = Ap, perm
                    probe_pack = probe_p

        host_tr = host_fw = None
        if directions in ("both", "transposed"):
            if probe_pack is not None:
                host_tr = probe_pack
            else:
                Phi = pack_stripe(A, method)
                host_tr = pack_1dvbc(A, Phi, W)
        if directions in ("both", "forward"):
            At = A.transpose()
            Phi_f = pack_stripe(At, method_forward)
            host_fw = pack_1dvbc(At, Phi_f, W)
        return VBCOperator(
            m=A.m, n=A.n, host_tr=host_tr, host_fw=host_fw, row_perm=row_perm
        )

    @property
    def shape(self):
        return (self.m, self.n)

    def memory_bytes(self) -> int:
        total = 0
        if self.host_tr is not None:
            total += self.host_tr.memory_bytes()
        if self.host_fw is not None:
            total += self.host_fw.memory_bytes()
        return total

    # ---- lazy device packing --------------------------------------------

    def device_format(self, which: str):
        """Device format of one direction ("tr": A, "fw": A.T), packed
        and placed on first use (in the matrix's own dtype — the
        reference runs Float64/Bool/Int32 semirings,
        test/runtests.jl:15-16 + src/hacks.jl:1)."""
        if which not in self._dev:
            host = self.host_tr if which == "tr" else self.host_fw
            if host is None:
                direction = "transposed" if which == "tr" else "forward"
                raise ValueError(
                    f"operator packed without the {direction} direction")
            self._dev[which] = route_tr_spmv(host)[1]
        return self._dev[which]

    def _perms(self):
        """(perm, inv) on device, or (None, None) without a relabeling."""
        if self.row_perm is None:
            return None, None
        if "perm" not in self._dev:
            perm = np.asarray(self.row_perm, dtype=np.int64)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            self._dev["perm"] = (
                jax.device_put(perm.astype(np.int32)),
                jax.device_put(inv.astype(np.int32)),
            )
        return self._dev["perm"]

    def _call(self, which, kernel, x, alpha=None, beta=None, y=None):
        fmt = self.device_format(which)
        perm, inv = self._perms()
        return _apply(kernel, fmt, jnp.asarray(x), perm, inv, alpha, beta, y)

    # ---- compute ---------------------------------------------------------

    def tr_mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A.T @ x) + beta * y on device (reference
        ``mul!(y, A', x, alpha, beta)`` — with ``alpha`` actually applied;
        the reference converts but ignores it, SURVEY §2.5 quirk)."""
        return self._call("tr", xla.tr_spmv, x, alpha, beta, y)

    def mul(self, x, alpha=None, beta=None, y=None):
        """y = alpha * (A @ x) + beta * y on device (scatter-free:
        gather kernel on the A.T pack)."""
        return self._call("fw", xla.tr_spmv, x, alpha, beta, y)

    def tr_mul_chain(self, x, n_iters: int, alpha=None):
        """y = (alpha * A.T)^n_iters @ x — iterative SpMV in one jitted
        loop (square operators)."""
        if self.m != self.n:
            raise ValueError(
                f"tr_mul_chain needs a square operator, got {self.shape}")
        fmt = self.device_format("tr")
        perm, inv = self._perms()
        return _chain(fmt, jnp.asarray(x), n_iters, perm, inv, alpha)

    def tr_mul_mat(self, X):
        """Y = A.T @ X (dense RHS [m, k])."""
        return self._call("tr", xla.tr_spmm, X)

    def mul_mat(self, X):
        """Y = A @ X (dense RHS [n, k]); with auto-RCM the operator is
        A[perm][:, perm], so X is gathered in and Y scattered back out."""
        return self._call("fw", xla.tr_spmm, X)  # (A.T).T @ X == A @ X

    # ---- host oracles -----------------------------------------------------

    def host_tr_mul(self, x):
        return self.host_tr.tr_mul(x)

    def host_mul(self, x):
        if self.host_fw is not None:
            return self.host_fw.tr_mul(x)  # (A.T).T @ x == A @ x
        return self.host_tr.mul(x)


@dataclasses.dataclass
class VBC2DOperator(VBCOperator):
    """Sparse matrix operator in 2-D VBC form (u x w dense tiles)
    (reference ``SparseMatrixVBC{U,W}``, ``src/SparseMatrixVBCs.jl:57-84``
    + ``src/multiply_VBC.jl``).

    Same call surface as :class:`VBCOperator`; the device format keeps
    tiles whole (one row base per tile, einsum tile contraction).  The
    forward direction is scatter-free like the 1-D operator: ``A.T`` is
    packed 2-D with U/W swapped and runs the same gather kernel.
    """

    @staticmethod
    def from_csc(
        A,
        U: int = 8,
        W: int = 8,
        method=None,
        method_forward=None,
        directions: str = "both",
    ) -> "VBC2DOperator":
        """Plan + pack ``A`` (and/or ``A.T``) into 2-D VBC operators.

        ``method`` plans (rows, columns) of A with heights <= U and
        widths <= W; ``method_forward`` plans A.T (defaults to the
        2-D default planner with U/W swapped).
        """
        from .api import default_2d_partitioner, vbc2d

        A = _as_csc(A)
        host_tr = host_fw = None
        if directions in ("both", "transposed"):
            m = method or default_2d_partitioner(U, W, A.val.dtype.itemsize)
            host_tr = vbc2d(A, U, W, m)
        if directions in ("both", "forward"):
            At = A.transpose()
            mf = method_forward or default_2d_partitioner(
                W, U, A.val.dtype.itemsize
            )
            host_fw = vbc2d(At, W, U, mf)
        return VBC2DOperator(m=A.m, n=A.n, host_tr=host_tr, host_fw=host_fw)
