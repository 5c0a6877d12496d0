"""Benchmark: 1D-VBC transposed SpMV (the reference's headline op) and
its neighbours on one GPU, through the operators' public methods.

    python bench.py [--group NAME ...]

Runs in one process on the first device.  Refuses to run when JAX finds
no GPU: a CPU timing is not a device measurement.  Prints one JSON line
per group, then one summary line; every line carries the device
(platform, kind, count as JAX reports them) and the card's name and
power limit as ``nvidia-smi`` reports them.

Groups (matrix generators below):

* ``oneshot``   — ``y = A.T @ x`` on the flagship banded blocky matrix
  (``blocky_matrix()``, ~2.5M nnz, sized like Boeing/ct20stif, the
  reference's flagship; ``bin/test_table.jl:80`` times this op);
* ``spmm``      — ``A.T @ X`` at k=128 on the flagship;
* ``chain``     — ``tr_mul_chain``: iterated SpMV in one jitted loop;
* ``scattered`` — an information-free scatter (``data/scattered.npz``),
  the regime where the reference falls back to CPU CSC;
* ``vbc2d``     — the 2-D operator on exact 4x8 tiles;
* ``fem``       — a scrambled 5-point Laplacian through auto-RCM.

Times are the median of several calls after warm-up, each ending in
``block_until_ready`` (``vbcs_tpu.utils.timing``); plan/pack/compile are
reported as set-up.  Roofline shares divide the bytes one call must move
(``vbcs_tpu.utils.profile.stream_bytes``) by the device's published
memory rate (``PEAKS``; an unknown device is an error).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def blocky_matrix(L=40000, w=8, d=8, band=400, seed=0):
    """Banded blocky matrix: L stripes of width w, d blocks per stripe
    with rows within +-band of the diagonal (RCM-ordered-FEM-like;
    mirrors the reference autotuner's synthetic family,
    src/costs.jl:63-82, plus locality)."""
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
    A.sort_indices()
    return A


def blocky2d_matrix(K=10000, u=4, w=8, d=8, band=400, seed=0):
    """Blocky matrix of exact u x w dense tiles (for the 2-D operator)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    m, n = K * u, K * w
    rb = np.clip(
        np.arange(K)[:, None] + rng.integers(-band, band, (K, d)), 0, K - 1
    )
    rows = rb.reshape(-1)[:, None] * u + np.arange(u)[None, :]
    rows = np.repeat(rows, w, axis=1).reshape(-1)
    cols = np.repeat(np.arange(K) * w, d)
    cols = (np.repeat(cols, u)[:, None] + np.arange(w)[None, :]).reshape(-1)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(m, n)).tocsc()
    A.sum_duplicates()
    A.sort_indices()
    return A


def fem_matrix(k=320, seed=5):
    """Scrambled 5-point grid Laplacian — thermal1-like FEM structure
    hidden behind a bad row ordering (auto-RCM recovers it)."""
    import scipy.sparse as sp

    n = k * k
    main = np.full(n, 4.0)
    off = -np.ones(n - 1)
    offk = -np.ones(n - k)
    A = sp.diags([main, off, off, offk, offk], [0, 1, -1, k, -k],
                 format="csc")
    rng = np.random.default_rng(seed)
    p = rng.permutation(n)
    return A[p][:, p].tocsc()


def scattered_matrix():
    """Information-free scatter (thermal1-sized).  Loaded from
    data/scattered.npz (pre-generated: sp.random at this size costs
    minutes of host RNG)."""
    import scipy.sparse as sp

    path = os.path.join(ROOT, "data", "scattered.npz")
    if os.path.exists(path):
        return sp.load_npz(path).tocsc()
    return sp.random(82654, 82654, 574458 / 82654**2, random_state=9,
                     format="csc").astype(np.float32)


def _timed(result, prefix, fn, nnz, nbytes, reps=20):
    """Median per-call time of ``fn()`` and the rates it implies."""
    from vbcs_tpu.utils.profile import hbm_bandwidth
    from vbcs_tpu.utils.timing import periter

    t = periter(fn, reps=reps)
    result[f"{prefix}_us"] = t * 1e6
    result[f"{prefix}_gnnz_s"] = nnz / t / 1e9
    result[f"{prefix}_bytes"] = int(nbytes)
    result[f"{prefix}_vs_hbm_peak"] = nbytes / t / hbm_bandwidth()
    return t


def _x(n, seed, k=None):
    import jax.numpy as jnp

    shape = (n,) if k is None else (n, k)
    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape),
                       jnp.float32)


def _flagship(result):
    from vbcs_tpu.operator import VBCOperator

    A = blocky_matrix()
    t0 = time.perf_counter()
    op = VBCOperator.from_csc(A, W=8, directions="transposed")
    result["setup_s"] = time.perf_counter() - t0
    result["nnz"] = int(A.nnz)
    return A, op


def run_oneshot(result):
    from vbcs_tpu.utils.profile import stream_bytes

    A, op = _flagship(result)
    x = _x(A.shape[0], 1)
    nbytes = stream_bytes(op.device_format("tr"))
    _timed(result, "tr_mul", lambda: op.tr_mul(x), A.nnz, nbytes)


def run_spmm(result):
    from vbcs_tpu.utils.profile import stream_bytes

    A, op = _flagship(result)
    k = 128
    X = _x(A.shape[0], 4, k)
    fmt = op.device_format("tr")
    # values + indices once, X read and Y written once
    nbytes = stream_bytes(fmt) - 4 * (fmt.m + fmt.n) + 4 * k * (fmt.m + fmt.n)
    _timed(result, "spmm_k128", lambda: op.tr_mul_mat(X), A.nnz * k, nbytes,
           reps=5)


def run_chain(result):
    from vbcs_tpu.utils.profile import stream_bytes

    A, op = _flagship(result)
    x = _x(A.shape[0], 1)
    n_iters = 100
    nbytes = stream_bytes(op.device_format("tr"))
    t = _timed(result, "chain", lambda: op.tr_mul_chain(x, n_iters, 0.999),
               A.nnz * n_iters, nbytes * n_iters, reps=5)
    result["chain_iter_us"] = t / n_iters * 1e6


def run_scattered(result):
    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.utils.profile import stream_bytes

    A = scattered_matrix().astype(np.float32)
    t0 = time.perf_counter()
    op = VBCOperator.from_csc(A, W=8, directions="transposed")
    result["scattered_setup_s"] = time.perf_counter() - t0
    x = _x(A.shape[0], 4)
    nbytes = stream_bytes(op.device_format("tr"))
    _timed(result, "scattered", lambda: op.tr_mul(x), A.nnz, nbytes)


def run_vbc2d(result):
    import vbcs_tpu as v
    from vbcs_tpu.operator import VBC2DOperator
    from vbcs_tpu.utils.profile import stream_bytes

    A = blocky2d_matrix()
    t0 = time.perf_counter()
    op = VBC2DOperator.from_csc(
        A, U=4, W=8,
        method=v.AlternatingPacker(v.EquiChunker(8), v.EquiChunker(4)),
        directions="transposed")
    result["vbc2d_setup_s"] = time.perf_counter() - t0
    x = _x(A.shape[0], 2)
    nbytes = stream_bytes(op.device_format("tr"))
    _timed(result, "vbc2d", lambda: op.tr_mul(x), A.nnz, nbytes)


def run_fem(result):
    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.utils.profile import stream_bytes

    A = fem_matrix().astype(np.float32)
    t0 = time.perf_counter()
    op = VBCOperator.from_csc(A, W=8, directions="transposed")
    result["fem_setup_s"] = time.perf_counter() - t0
    result["fem_rcm_applied"] = op.row_perm is not None
    x = _x(A.shape[0], 3)
    nbytes = stream_bytes(op.device_format("tr"))
    _timed(result, "fem", lambda: op.tr_mul(x), A.nnz, nbytes)


GROUPS = {
    "oneshot": run_oneshot,
    "spmm": run_spmm,
    "chain": run_chain,
    "scattered": run_scattered,
    "vbc2d": run_vbc2d,
    "fem": run_fem,
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--group", action="append", choices=sorted(GROUPS),
                    help="run only these groups (repeatable)")
    args = ap.parse_args(argv)

    from vbcs_tpu.utils.compile_cache import enable_compile_cache
    from vbcs_tpu.utils.profile import (device_fields, gpu_name_power_limit,
                                        peak)

    device = device_fields()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX found {device}")
    enable_compile_cache(ROOT)
    peak()  # an unknown device stops here, before any measurement
    card = gpu_name_power_limit()
    summary = {"metric": "1dvbc_trspmv_nnz_per_s", "unit": "Gnnz/s",
               "value": None}
    for name in args.group or list(GROUPS):
        result = {"group": name, "device": device, "card": card}
        GROUPS[name](result)
        print(json.dumps(result), flush=True)
        summary.update({k: v for k, v in result.items() if k != "group"})
    summary["value"] = summary.get("tr_mul_gnnz_s")
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
