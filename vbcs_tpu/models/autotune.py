"""Autotuned execution-time cost model for the DP planner.

Re-implements the reference's headline capability (``src/costs.jl:12-136``
and §3.4 of SURVEY.md) on the device: measure the real TrSpMV kernel on
synthetic width-uniform matrices, fit per-width costs by relative-error
least squares, monotonize, and feed the result to the optimal DP as a
:class:`~vbcs_tpu.models.cost.ColumnBlockComponentCostModel` with
per-width tables.

Differences from the reference, by design:

* the benchmarked kernel is the one the operators run — the kernel
  ``VBCOperator.tr_mul`` / ``VBC2DOperator.tr_mul`` route for each
  synthetic's format (``operator.route_tr_spmv``; the reference
  likewise times the same ``mul!`` its harness measures,
  ``src/costs.jl:87-94``) — timed on the host clock around calls that
  end in ``block_until_ready`` (``utils/timing.py``) instead of
  BenchmarkTools;
* problem sizes target a fixed device-memory working set
  (``target_bytes``) instead of "half of L2" (``src/costs.jl:44-60``);
* results are disk-cached keyed by (device kind, dtype, W, generator
  params) — the analog of the reference's ``arch_id()``-keyed
  DiskCache (``src/util.jl:52``, ``src/costs.jl:14``).

The fit model (the reference design matrix at ``src/costs.jl:112-122``
plus a per-excess-group term):
``t ~ alpha_col[w] * L + beta_col[w] * q + gamma_col[w] * E`` for a
width-w matrix with L stripes, q blocks, and E = sum max(ceil(nb/8)-1,
0) excess 8-block groups.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

from .cost import ColumnBlockComponentCostModel

__all__ = [
    "model_1dvbc_trspmv_time",
    "autotune_1dvbc_trspmv",
    "model_vbc_trspmv_time",
    "autotune_vbc_trspmv",
]

_CACHE_DIR = os.path.join(
    os.environ.get("VBCS_CACHE", os.path.expanduser("~/.cache/vbcs_tpu")),
    "autotune",
)


def _arch_id() -> str:
    """Device fingerprint (reference ``arch_id()``: SHA of cpuinfo)."""
    import jax

    d = jax.devices()[0]
    key = f"{d.platform}|{getattr(d, 'device_kind', '?')}|{jax.__version__}"
    return hashlib.sha256(key.encode()).hexdigest()[:16]


def _synth(L, w, d, band, seed):
    """Width-uniform banded blocky matrix (reference src/costs.jl:63-82
    plus row locality)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m = L * w
    cs = np.arange(L) * w + w // 2
    rr = np.clip(cs[:, None] + rng.integers(-band, band, (L, d)), 0, m - 1)
    rows = np.repeat(rr.reshape(-1), w)
    cols = (
        np.repeat(np.arange(L) * w, d)[:, None] + np.arange(w)[None, :]
    ).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, m)).tocsc()
    A.sum_duplicates()
    return A


def _synth_fem(k):
    """5-point grid Laplacian in natural band order (what auto-RCM
    recovers from a scrambled FEM matrix — the bench's fem stage) —
    a synthetic family where rows scatter across +-k, so narrow stripes
    can win."""
    import scipy.sparse as sp

    n = k * k
    main = np.full(n, 4.0)
    off = -np.ones(n - 1)
    offk = -np.ones(n - k)
    return sp.diags(
        [main, off, off, offk, offk], [0, 1, -1, k, -k], format="csc"
    ).astype(np.float32)


def _measure_routed(B, reps=8):
    """Seconds per call of the routed TrSpMV for a packed format ``B``
    (1-D or 2-D) — the kernel the operators' ``tr_mul`` runs
    (``operator.route_tr_spmv``) — and the route's name.  Host clock
    around calls that end in ``block_until_ready``."""
    import jax
    import jax.numpy as jnp

    from ..operator import route_tr_spmv
    from ..utils.timing import periter

    kname, fmt, call = route_tr_spmv(B)
    x = jnp.asarray(
        np.random.default_rng(0).standard_normal(B.m), jnp.float32
    )
    f = jax.jit(call)
    return periter(lambda: f(fmt, x), reps=reps), kname


def autotune_1dvbc_trspmv(
    W: int = 8,
    d: int = 8,
    target_bytes: int = 64 << 20,
    band: int = 400,
    verbose: bool = False,
    cache: bool = True,
    measure=None,
    require_cache: bool = False,
):
    """Measure + fit; returns (alpha_col[W], beta_col[W],
    gamma_col[W]) tables (ns; gamma is charged per EXCESS 8-block
    group, see ColumnBlockComponentCostModel).

    ``require_cache=True`` raises FileNotFoundError instead of running
    the on-device measurement when no disk cache exists — for callers
    (harnesses, library defaults) that must never trigger a
    multi-minute autotune.

    ``measure(B, w) -> seconds | None`` overrides the on-device timing
    (used by tests to exercise the fit pipeline CPU-only).

    Two synthetic families feed the fit:

    * banded blocky (the reference's family, ``src/costs.jl:63-82``) —
      d full blocks per stripe near the diagonal: the regime where
      wide stripes are fast;
    * FEM-like — a 5-point grid Laplacian (natural band order, i.e.
      what auto-RCM produces), equi-partitioned at each width: rows
      scatter across +-k, so wider stripes gather x from farther apart.
      Without these samples the fit only sees width-friendly matrices
      and can anti-rank plans on FEM matrices.
    """
    key = json.dumps(
        dict(W=W, d=d, tb=target_bytes, band=band, arch=_arch_id(), v=8)
    )
    path = os.path.join(
        _CACHE_DIR, hashlib.sha256(key.encode()).hexdigest()[:24] + ".json"
    )
    if cache and os.path.exists(path):
        data = json.load(open(path))
        return (np.asarray(data["alpha"]), np.asarray(data["beta"]),
                np.asarray(data["gamma"]))
    if require_cache:
        raise FileNotFoundError(
            f"no cached autotune tables for this device ({path})")

    from ..formats.csc import CSC
    from ..formats.partition import SplitPartition
    from ..formats.vbc1d import pack_1dvbc

    ms, Ls, ws, qs, Gs, ts, kernels = [], [], [], [], [], [], []

    def add_sample(A, w):
        C = CSC.from_scipy(A)
        B = pack_1dvbc(C, SplitPartition.equi(C.n, w), W)
        if measure is not None:
            t, kname = measure(B, w), "injected"
        else:
            t, kname = _measure_routed(B)
        if t is None:
            return  # drop this sample
        nb = (B.pos[1:] - B.pos[:-1]).astype(np.int64)
        ms.append(C.m)
        Ls.append(len(B.Phi))
        ws.append(w)
        qs.append(B.num_blocks)
        Gs.append(int(np.maximum(-(-nb // 8) - 1, 0).sum()))  # EXCESS groups
        ts.append(t * 1e9)  # ns
        kernels.append(kname)
        if verbose:
            print(
                f"w={w} L={len(B.Phi)} q={B.num_blocks} E={Gs[-1]} "
                f"t={t*1e6:.1f}us "
                f"({B.num_blocks*w/t/1e9:.1f} Gnnz/s) [{kname}]"
            )

    for w in range(W, 0, -1):
        # L sized so the stream (val + row + gseg + x + y) ~ target_bytes
        bytes_per_block = 8 * w * 4 + 8 * 4 + 4  # interleaved f32 + meta
        L0 = max(2048, int(target_bytes / (d * bytes_per_block + 2 * w * 4)))
        for Lf, qf in [(1.0, 1.0), (0.5, 1.0), (1.0, 0.5)]:
            L = max(1024, int(L0 * Lf))
            dd = max(1, int(d * qf))
            add_sample(_synth(L, w, dd, band, seed=w * 7 + int(Lf * 2)), w)
        if measure is None:
            # FEM-like family: banded Laplacian whose per-stripe row
            # sets grow with w (the narrow-width-wins regime)
            add_sample(_synth_fem(max(64, band // 2)), w)
            # multi-group banded: nb = 2d+1 > 8 blocks per stripe
            # decouples the per-GROUP cost from the per-stripe one (on
            # single-group samples G == L exactly — collinear)
            Lmg = max(1024, L0 // 3)
            add_sample(_synth(Lmg, w, 2 * d + 1, band, seed=w * 13), w)

    # relative-error LSQ on one-hot design (reference src/costs.jl:112-122).
    # NO m column: the reference's synthetics have m independent of L*w,
    # but ours are square (m == L*w exactly), which makes an m column
    # collinear with the L*e_w block, and a fit with it returns a
    # degenerate w-linear alpha_col compensated by a huge negative
    # alpha_row.  The per-stripe alpha absorbs the row term.  Third
    # feature block: E = sum max(ceil(nb/8) - 1, 0) (EXCESS 8-block
    # groups) separates a single-group stripe from a multi-group one;
    # charging TOTAL groups forces a negative alpha that clipping
    # re-breaks.
    N = len(ts)
    D = np.zeros((N, 3 * W))
    for i in range(N):
        D[i, ws[i] - 1] = Ls[i]
        D[i, W + ws[i] - 1] = qs[i]
        D[i, 2 * W + ws[i] - 1] = Gs[i]
    T = np.asarray(ts)
    sol, *_ = np.linalg.lstsq(D / T[:, None], np.ones(N), rcond=None)
    alpha = sol[:W].copy()
    beta = sol[W:2 * W].copy()
    gamma = sol[2 * W:].copy()
    # NO width-monotonization (deliberate departure from the reference
    # discipline, src/costs.jl:127-131): the device format pads widths
    # to power-of-two classes, so w=5..7 stream as many values as w=8
    # and can cost more per stripe than w=8; forcing alpha[8] >=
    # alpha[7] would lift the width-8 cost above its measurement.
    # Clip at >= 0 only.
    alpha = np.maximum(alpha, 0.0)
    beta = np.maximum(beta, 0.0)
    gamma = np.maximum(gamma, 0.0)
    if cache:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        json.dump(
            {"alpha": alpha.tolist(), "beta": beta.tolist(),
             "gamma": gamma.tolist(), "data": dict(
                 ms=ms, Ls=Ls, ws=ws, qs=qs, Gs=Gs, ts=ts,
                 kernels=kernels)},
            open(path, "w"),
        )
    return alpha, beta, gamma


def model_1dvbc_trspmv_time(W: int = 8, **kwargs) -> ColumnBlockComponentCostModel:
    """Autotuned time model for the DP (reference
    ``model_SparseMatrix1DVBC_TrSpMV_time``, ``src/costs.jl:12``)."""
    alpha, beta, gamma = autotune_1dvbc_trspmv(W, **kwargs)
    return ColumnBlockComponentCostModel(
        alpha_col=alpha, beta_col=beta, gamma_col=gamma)


def _synth2d(K, u, L, w, d, band, seed):
    """(u, w)-uniform 2-D blocky matrix: K row blocks of height u, L
    column stripes of width w, ~d dense u x w tiles per stripe placed
    near the diagonal (reference's 2-D synthetic family,
    ``src/costs.jl:195-222``, plus banding for row locality)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m, n = K * u, L * w
    cb = (np.arange(L) * w) // max(u, 1)  # diagonal row-block per stripe
    bb = max(1, band // max(u, 1))
    rb = np.clip(cb[:, None] + rng.integers(-bb, bb + 1, (L, d)), 0, K - 1)
    # tile (l, k) -> u*w COO entries
    l_t = np.repeat(np.arange(L), d)
    k_t = rb.reshape(-1)
    rows = (k_t[:, None] * u + np.arange(u)[None, :]).reshape(-1)
    rows = np.repeat(rows, w)
    cols = np.broadcast_to(
        (l_t[:, None] * w + np.arange(w)[None, :])[:, None, :], (L * d, u, w)
    ).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    A.sum_duplicates()
    return A


def autotune_vbc_trspmv(
    U: int = 4,
    W: int = 8,
    d: int = 8,
    target_bytes: int = 64 << 20,
    band: int = 400,
    rank: int = 3,
    verbose: bool = False,
    cache: bool = True,
    measure=None,
    subsample: bool = True,
):
    """Measure + fit the 2-D time model (reference ``src/costs.jl:249-290``).

    Returns ``(alpha_row[U], alpha_col[W], beta_row, beta_col)`` where
    ``beta_row``/``beta_col`` are rank-``R`` tuples of per-size tables
    from the SVD factorization of the monotonized beta[u, w] grid
    (reference ``src/costs.jl:279-284``).

    The benchmarked kernel is the one ``VBC2DOperator.tr_mul`` runs
    for that (u, w) synthetic (``operator.route_tr_spmv``).

    ``subsample=True`` measures only power-of-two block sizes (plus U/W)
    and linearly interpolates the remaining table entries — every
    (u, w) cell costs a kernel compile, so the full U x W grid is
    compile-bound.  The reference measures every size
    (``src/costs.jl:195``); its per-size cost is a JIT already warm.
    """
    key = json.dumps(
        dict(
            U=U, W=W, d=d, tb=target_bytes, band=band, arch=_arch_id(),
            sub=bool(subsample), v=5,
        )
    )
    path = os.path.join(
        _CACHE_DIR, hashlib.sha256(key.encode()).hexdigest()[:24] + ".json"
    )
    if cache and os.path.exists(path):
        z = json.load(open(path))
        return (
            np.asarray(z["alpha_row"]),
            np.asarray(z["alpha_col"]),
            tuple(np.asarray(t) for t in z["beta_row"]),
            tuple(np.asarray(t) for t in z["beta_col"]),
        )

    from ..formats.csc import CSC
    from ..formats.partition import SplitPartition
    from ..formats.vbc2d import pack_vbc2d
    def _sizes(n):
        if not subsample:
            return list(range(1, n + 1))
        s, k = set(), 1
        while k <= n:
            s.add(k)
            k *= 2
        s.add(n)
        return sorted(s)

    u_sizes, w_sizes = _sizes(U), _sizes(W)
    Ks, Ls, us, ws, qs, ts = [], [], [], [], [], []
    for u in reversed(u_sizes):
        for w in reversed(w_sizes):
            bytes_per_tile = u * w * 4 + 8 + u * 8 * 4 / max(u, 1)
            L0 = max(
                2048, int(target_bytes / (d * bytes_per_tile + 2 * w * 4))
            )
            # vary L, blocks/stripe, and K independently so the
            # [K e_u | L e_w | q e_{u,w}] design is full-rank (K would
            # otherwise be collinear with L at fixed u, w)
            for Lf, qf, Kf in (
                (1.0, 1.0, 1.0),
                (0.5, 1.0, 1.0),
                (1.0, 0.5, 1.0),
                (1.0, 1.0, 2.0),
            ):
                L = max(1024, int(L0 * Lf))
                K = max(1, int((L * w) // u * Kf))
                dd = max(1, int(d * qf))
                A = _synth2d(
                    K,
                    u,
                    L,
                    w,
                    dd,
                    band,
                    seed=u * 31 + w * 7 + int(qf * 2) + int(Kf),
                )
                C = CSC.from_scipy(A)
                B2 = pack_vbc2d(
                    C,
                    SplitPartition.equi(C.m, u),
                    SplitPartition.equi(C.n, w),
                    U,
                    W,
                )
                if measure is not None:
                    t = measure(B2, u, w)
                else:
                    t, _kname = _measure_routed(B2)
                if t is None:
                    continue
                Ks.append(len(B2.Pi))
                Ls.append(len(B2.Phi))
                us.append(u)
                ws.append(w)
                qs.append(B2.num_blocks)
                ts.append(t * 1e9)
                if verbose:
                    print(
                        f"u={u} w={w} L={L} q={B2.num_blocks} t={t*1e6:.1f}us"
                        f" ({B2.num_blocks*u*w/t/1e9:.1f} Gnnz/s)"
                    )

    # relative-error LSQ on [K e_u; L e_w; q e_{u,w}] (src/costs.jl:252-263)
    N = len(ts)
    nu, nw = len(u_sizes), len(w_sizes)
    upos = {u: i for i, u in enumerate(u_sizes)}
    wpos = {w: i for i, w in enumerate(w_sizes)}
    D = np.zeros((N, nu + nw + nu * nw))
    for i in range(N):
        D[i, upos[us[i]]] = Ks[i]
        D[i, nu + wpos[ws[i]]] = Ls[i]
        D[i, nu + nw + upos[us[i]] * nw + wpos[ws[i]]] = qs[i]
    T = np.asarray(ts)
    sol, *_ = np.linalg.lstsq(D / T[:, None], np.ones(N), rcond=None)
    alpha_row_s = np.maximum(sol[:nu], 0.0)
    alpha_col_s = np.maximum(sol[nu : nu + nw], 0.0)
    beta_s = np.maximum(sol[nu + nw :].reshape(nu, nw), 0.0)
    # expand sampled sizes to full 1..U / 1..W tables (linear interp)
    full_u = np.arange(1, U + 1, dtype=np.float64)
    full_w = np.arange(1, W + 1, dtype=np.float64)
    alpha_row = np.interp(full_u, u_sizes, alpha_row_s)
    alpha_col = np.interp(full_w, w_sizes, alpha_col_s)
    beta_w = np.stack([np.interp(full_w, w_sizes, r) for r in beta_s])
    beta = np.stack(
        [np.interp(full_u, u_sizes, beta_w[:, j]) for j in range(W)], axis=1
    )
    # monotonize along both axes (src/costs.jl:268-277)
    for uu in range(1, U):
        alpha_row[uu] = max(alpha_row[uu], alpha_row[uu - 1])
        beta[uu, :] = np.maximum(beta[uu, :], beta[uu - 1, :])
    for ww in range(1, W):
        alpha_col[ww] = max(alpha_col[ww], alpha_col[ww - 1])
        beta[:, ww] = np.maximum(beta[:, ww], beta[:, ww - 1])
    # rank-R SVD factorization so the DP stays separable (:279-284)
    Um, s, Vt = np.linalg.svd(beta, full_matrices=False)
    R = min(rank, s.size)
    beta_row = tuple(Um[:, r] * np.sqrt(s[r]) for r in range(R))
    beta_col = tuple(Vt[r, :] * np.sqrt(s[r]) for r in range(R))
    if cache:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        json.dump(
            {
                "alpha_row": alpha_row.tolist(),
                "alpha_col": alpha_col.tolist(),
                "beta_row": [t_.tolist() for t_ in beta_row],
                "beta_col": [t_.tolist() for t_ in beta_col],
                "data": dict(Ks=Ks, Ls=Ls, us=us, ws=ws, qs=qs, ts=ts),
            },
            open(path, "w"),
        )
    return alpha_row, alpha_col, beta_row, beta_col


def model_vbc_trspmv_time(U: int = 4, W: int = 8, **kwargs):
    """Autotuned 2-D time model (reference
    ``model_SparseMatrixVBC_TrSpMV_time``, ``src/costs.jl:144-290``)."""
    from .cost import BlockComponentCostModel

    alpha_row, alpha_col, beta_row, beta_col = autotune_vbc_trspmv(
        U, W, **kwargs
    )
    return BlockComponentCostModel(
        alpha_row=alpha_row,
        alpha_col=alpha_col,
        beta_row=beta_row,
        beta_col=beta_col,
    )
