"""Static-shape device formats: width-class-binned VBC pytrees.

The central tension of a compiled-XLA build of VBC (SURVEY.md §7 "hard
parts"): XLA needs static shapes, while VBC stripes have variable width
w <= W and 2-D blocks variable height u <= U.  The reference solves the CPU version
with runtime if-chains over a small width set generated per kernel
(``src/multiply_1DVBC.jl:13-18`` via ``le_nest``/``eq_nest``,
``src/util.jl:28-50``).  The answer here is *offline binning*:
stripes (1-D) / blocks (2-D) are grouped by power-of-two size classes and
zero-padded to the class size, giving one static-shape tensor bundle per
class — one kernel instance per class instead of one branch per width.
Zero padding plays the role of the reference's SIMD tail fill
(``constructors_1DVBC.jl:35-39``): padded lanes multiply to exact 0.0 and
never perturb results.

Per 1-D class ``c`` (padded width ``w``):
  * ``val [Q, w]``   block values (padded blocks are all-zero)
  * ``row [Q]``      block row index (gather index into x for A^T x)
  * ``seg [Q]``      stripe id within the class (segment-sum key;
                     padded blocks get ``seg == L`` and are dropped)
  * ``ycol [L]``     output column start of each stripe

Per 2-D class (padded ``u x w``): same plus ``rowstart [Q]`` replaces
``row`` (the first row of the block's row-block).

All index arrays are int32 (XLA's native index width on the device).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import numpy as np

from .vbc1d import VBC1D
from .vbc2d import VBC2D

__all__ = [
    "VBC1DClass",
    "VBC1DDevice",
    "VBC2DClass",
    "VBC2DDevice",
    "size_classes",
    "size_class_of",
    "bin_vbc1d",
    "bin_vbc2d",
]


def size_classes(maxdim: int) -> list[int]:
    """Power-of-two size classes covering 1..maxdim: [1, 2, 4, ..., 2^ceil]."""
    cs = [1]
    while cs[-1] < maxdim:
        cs.append(cs[-1] * 2)
    return cs


def size_class_of(x: int, classes: list[int]) -> int:
    """Index of the smallest class >= x."""
    for i, c in enumerate(classes):
        if x <= c:
            return i
    raise ValueError(f"size {x} exceeds largest class {classes[-1]}")


def _pad_rows(a: np.ndarray, q_pad: int) -> np.ndarray:
    out = np.zeros((q_pad,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["val", "row", "seg", "ycol"],
    meta_fields=["w", "num_stripes"],
)
@dataclasses.dataclass(frozen=True)
class VBC1DClass:
    w: int  # static padded width
    num_stripes: int  # static L for this class
    val: jax.Array  # [Q_pad, w]
    row: jax.Array  # [Q_pad] int32
    seg: jax.Array  # [Q_pad] int32 (pad blocks -> num_stripes)
    ycol: jax.Array  # [num_stripes] int32


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["classes"],
    meta_fields=["m", "n", "dtype_name"],
)
@dataclasses.dataclass(frozen=True)
class VBC1DDevice:
    m: int
    n: int
    dtype_name: str
    classes: tuple  # tuple[VBC1DClass, ...]

    @property
    def nbytes(self) -> int:
        total = 0
        for c in self.classes:
            total += c.val.size * c.val.dtype.itemsize
            total += c.row.size * 4 + c.seg.size * 4 + c.ycol.size * 4
        return total


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["val", "rowstart", "seg", "ycol"],
    meta_fields=["u", "w", "num_stripes"],
)
@dataclasses.dataclass(frozen=True)
class VBC2DClass:
    u: int  # static padded height
    w: int  # static padded width
    num_stripes: int
    val: jax.Array  # [Q_pad, u, w]
    rowstart: jax.Array  # [Q_pad] int32
    seg: jax.Array  # [Q_pad] int32
    ycol: jax.Array  # [num_stripes] int32


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["classes"],
    meta_fields=["m", "n", "dtype_name"],
)
@dataclasses.dataclass(frozen=True)
class VBC2DDevice:
    m: int
    n: int
    dtype_name: str
    classes: tuple  # tuple[VBC2DClass, ...]

    @property
    def nbytes(self) -> int:
        total = 0
        for c in self.classes:
            total += c.val.size * c.val.dtype.itemsize
            total += c.rowstart.size * 4 + c.seg.size * 4 + c.ycol.size * 4
        return total


def bin_vbc1d(
    B: VBC1D, dtype=None, block_pad: int = 8, device_put: bool = True
) -> VBC1DDevice:
    """Bin a host 1D-VBC matrix into width classes.

    ``block_pad``: pad each class's block count to a multiple of it
    (padded blocks are all-zero and land in the dropped segment).
    """
    dtype = np.dtype(dtype or B.val.dtype)
    classes = size_classes(B.W)
    widths = B.Phi.widths()
    cls_of_stripe = np.array([size_class_of(int(w), classes) for w in widths])

    out = []
    for ci, wc in enumerate(classes):
        stripes = np.flatnonzero(cls_of_stripe == ci)
        if stripes.size == 0:
            continue
        Lc = stripes.size
        nblocks = (B.pos[stripes + 1] - B.pos[stripes]).astype(np.int64)
        Q = int(nblocks.sum())
        Qp = max(block_pad, int(-(-Q // block_pad) * block_pad))
        val = np.zeros((Qp, wc), dtype=dtype)
        row = np.zeros(Qp, dtype=np.int32)
        seg = np.full(Qp, Lc, dtype=np.int32)  # pad -> dropped segment
        ycol = B.Phi.spl[stripes].astype(np.int32)
        q = 0
        for s_local, l in enumerate(stripes):
            nb = int(nblocks[s_local])
            w = int(widths[l])
            val[q : q + nb, :w] = B.stripe_vals(int(l)).astype(dtype)
            row[q : q + nb] = B.idx[B.pos[l] : B.pos[l + 1]]
            seg[q : q + nb] = s_local
            q += nb
        node = VBC1DClass(
            w=wc,
            num_stripes=int(Lc),
            val=val,
            row=row,
            seg=seg,
            ycol=ycol,
        )
        out.append(node)

    dev = VBC1DDevice(
        m=B.m, n=B.n, dtype_name=str(dtype), classes=tuple(out)
    )
    if device_put:
        dev = jax.device_put(dev)
    return dev


def bin_vbc2d(
    B: VBC2D, dtype=None, block_pad: int = 8, device_put: bool = True
) -> VBC2DDevice:
    """Bin a host 2-D VBC matrix into (height, width) size classes.

    Blocks of one stripe may land in different height classes; each class
    keeps its own per-stripe segment list, and the partial stripe outputs
    recombine additively in y (scatter-add is associative here because
    stripe output slices are disjoint).
    """
    dtype = np.dtype(dtype or B.val.dtype)
    u_classes = size_classes(B.U)
    w_classes = size_classes(B.W)
    heights = B.Pi.widths()
    widths = B.Phi.widths()
    wcls_of_stripe = np.array([size_class_of(int(w), w_classes) for w in widths])

    # Walk all blocks once, grouping by (u_class, w_class).
    groups: dict[tuple[int, int], list] = {}
    for l in range(B.L):
        wci = int(wcls_of_stripe[l])
        j0, _ = B.Phi.chunk(l)
        for k, i0, u, tile in B._stripe_blocks(l):
            uci = size_class_of(int(u), u_classes)
            groups.setdefault((uci, wci), []).append((l, i0, tile))

    out = []
    for (uci, wci), blocks in sorted(groups.items()):
        uc, wc = u_classes[uci], w_classes[wci]
        stripe_ids = sorted({l for (l, _, _) in blocks})
        stripe_pos = {l: s for s, l in enumerate(stripe_ids)}
        Lc = len(stripe_ids)
        Q = len(blocks)
        Qp = max(block_pad, -(-Q // block_pad) * block_pad)
        val = np.zeros((Qp, uc, wc), dtype=dtype)
        rowstart = np.zeros(Qp, dtype=np.int32)
        seg = np.full(Qp, Lc, dtype=np.int32)
        ycol = B.Phi.spl[np.array(stripe_ids, dtype=np.int64)].astype(np.int32)
        for q, (l, i0, tile) in enumerate(blocks):
            u, w = tile.shape
            val[q, :u, :w] = tile.astype(dtype)
            rowstart[q] = i0
            seg[q] = stripe_pos[l]
        out.append(
            VBC2DClass(
                u=uc,
                w=wc,
                num_stripes=Lc,
                val=val,
                rowstart=rowstart,
                seg=seg,
                ycol=ycol,
            )
        )

    dev = VBC2DDevice(
        m=B.m, n=B.n, dtype_name=str(dtype), classes=tuple(out)
    )
    if device_put:
        dev = jax.device_put(dev)
    return dev
