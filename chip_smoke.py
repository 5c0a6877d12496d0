"""Smoke test of vbcs_tpu on one NVIDIA GPU, at real sizes.

    python chip_smoke.py          # every single-card phase, one card
    python chip_smoke.py --four   # only the 4-card mesh phase

Drives the library's main path once through the public operator
surface (plan, pack, ``VBCOperator`` / ``VBC2DOperator`` calls) and
checks every result against scipy in float64.  Phases:

1. 1-D at ~41M nnz (``bench.blocky_matrix(L=640_000)``): plan and pack
   times, ``tr_mul``, ``mul``, ``tr_mul`` with alpha/beta/y,
   ``tr_mul_chain``; device kernels per ``tr_mul`` from a profiler trace.
2. SpMM: ``tr_mul_mat`` / ``mul_mat`` at k=128 on the 2.5M-nnz flagship.
3. 2-D at ~41M nnz (``bench.blocky2d_matrix(K=160_000)``).
4. Auto-RCM on a scrambled 4.2M-row FEM Laplacian.
5. The unstructured matrix ``data/scattered.npz``.
6. Other semirings: fp64 at the phase-1 size, int32 on the corpus.

Tolerance, elementwise: ``|y - y_ref| <= tol * (|A|^T |x|)`` with
``tol = 1e-5`` in f32 and ``1e-12`` in f64 (times the number of steps
for the chain).  Each output sums fewer than 64 products, the GPU's
scatter-add atomics add them in an order that varies from run to run,
and every contraction runs at ``Precision.HIGHEST`` (no TF32).  Int32
must match exactly.

Each phase also prints ``memory_analysis()`` of the compiled kernel, the
device's peak bytes in use so far, and, as information only, the median
time per call with its share of the published memory rate beside the
card's name and power limit.

Exits non-zero, printing no result, unless JAX's first device is a GPU.
The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import argparse
import gc
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
F32_TOL = 1e-5
F64_TOL = 1e-12


def log(msg: str) -> None:
    print(msg, flush=True)


class Context:
    """What every informational line names: the card and its peak."""

    def __init__(self, card: str = "not measured", hbm_bytes_per_s=None):
        self.card = card
        self.hbm_bytes_per_s = hbm_bytes_per_s


# ---- checks ----------------------------------------------------------------


def check(label, got, want, scale, tol):
    """Elementwise ``|got - want| <= tol * scale``; raises on failure."""
    got = np.asarray(got)
    if got.shape != want.shape:
        raise AssertionError(f"{label}: shape {got.shape} != {want.shape}")
    if not np.all(np.isfinite(got)):
        raise AssertionError(f"{label}: non-finite output")
    err = np.abs(got.astype(np.float64) - want)
    ok = bool(np.all(err <= tol * scale))
    pos = scale > 0
    ratio = float(np.max(err[pos] / scale[pos])) if pos.any() else 0.0
    log(f"  {label}: max abs err {float(err.max(initial=0.0)):.3e}, "
        f"max err/(|A|^T|x|) {ratio:.3e}, tolerance {tol:g} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: error exceeds tolerance")


def check_apply(label, got, A, x, tol, transpose=True, alpha=1.0,
                beta=None, y=None):
    """Check ``got == alpha * op(A) @ x + beta * y`` (op = transpose or
    identity) against scipy in float64."""
    M = (A.T if transpose else A).astype(np.float64)
    x64 = np.asarray(x, dtype=np.float64)
    want = alpha * (M @ x64)
    scale = abs(alpha) * (abs(M) @ np.abs(x64))
    if y is not None:
        y64 = np.asarray(y, dtype=np.float64)
        want = want + beta * y64
        scale = scale + abs(beta) * np.abs(y64)
    check(label, got, want, scale, tol)


# ---- per-phase device reports ------------------------------------------------


def report_memory(label, kernel, fmt, x):
    """``memory_analysis()`` of ``kernel(fmt, x)`` compiled, and the
    device's peak bytes in use so far."""
    import jax

    ma = jax.jit(kernel).lower(fmt, x).compile().memory_analysis()
    if ma is not None:
        log(f"  {label} memory_analysis: "
            f"arguments {ma.argument_size_in_bytes} B, "
            f"outputs {ma.output_size_in_bytes} B, "
            f"temporaries {ma.temp_size_in_bytes} B, "
            f"generated code {ma.generated_code_size_in_bytes} B")
    stats = jax.devices()[0].memory_stats()
    peak = (stats or {}).get("peak_bytes_in_use")
    log(f"  device peak_bytes_in_use so far: "
        f"{peak if peak is not None else 'not reported'}")


def report_time(ctx, label, fn, nbytes, reps=10):
    """Median time per call (information only) and the share of the
    published memory rate that ``nbytes`` per call implies."""
    from vbcs_tpu.utils.timing import periter

    t = periter(fn, reps=reps)
    share = (f"{nbytes / t / ctx.hbm_bytes_per_s:.4f}"
             if ctx.hbm_bytes_per_s else "not measured")
    log(f"  {label}: {t * 1e6:.2f} us/call (median of {reps}), "
        f"{nbytes} B/call, share of published memory rate {share} "
        f"[card: {ctx.card}]")
    return t


def kernels_per_call(fn, n_calls=5):
    """Device kernels per call of ``fn()`` from one profiler trace, and
    each kernel's device time per call: events on the first GPU's
    stream lines over ``n_calls`` calls.  Returns ``(kernels_per_call,
    {kernel name: device us per call})``; ``(None, {})`` when the trace
    holds no GPU plane."""
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(n_calls):
                jax.block_until_ready(fn())
        paths = sorted(glob.glob(os.path.join(d, "plugins", "profile", "*",
                                              "*.xplane.pb")))
        pd = ProfileData.from_file(paths[-1])
        kernels, us = 0, {}
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU:0"):
                continue
            for line in plane.lines:
                if not line.name.lower().startswith("stream"):
                    continue
                for e in line.events:
                    kernels += 1
                    us[e.name] = us.get(e.name, 0.0) + e.duration_ns / 1e3
    if not kernels:
        return None, {}
    per_call = {k: t / n_calls for k, t in
                sorted(us.items(), key=lambda kv: -kv[1])}
    return kernels / n_calls, per_call


# ---- phases -------------------------------------------------------------------


def phase_1d(ctx, L=640_000, chain_iters=20, trace=True):
    """1-D VBC at real size; returns the matrix and its operator (phase 6
    reuses both)."""
    import jax.numpy as jnp

    import bench
    import vbcs_tpu as v
    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.ops import xla
    from vbcs_tpu.utils.profile import stream_bytes

    log(f"phase 1: 1-D VBC, bench.blocky_matrix(L={L})")
    A = bench.blocky_matrix(L=L)
    C = v.CSC.from_scipy(A)
    method = v.default_1d_partitioner(8, A.dtype.itemsize)
    t0 = time.perf_counter()
    Phi = v.pack_stripe(C, method)
    t1 = time.perf_counter()
    v.pack_1dvbc(C, Phi, 8)
    t2 = time.perf_counter()
    log(f"  {A.shape[0]}x{A.shape[1]}, nnz {A.nnz}; set-up: plan (DP "
        f"min-memory) {t1 - t0:.3f} s, pack {t2 - t1:.3f} s")
    t0 = time.perf_counter()
    op = VBCOperator.from_csc(A, W=8)
    fmt = op.device_format("tr")
    op.device_format("fw")
    log(f"  set-up: VBCOperator.from_csc + device formats (both "
        f"directions) {time.perf_counter() - t0:.3f} s; "
        f"row_perm {'applied' if op.row_perm is not None else 'none'}")

    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(A.shape[0]), jnp.float32)
    xf = jnp.asarray(rng.standard_normal(A.shape[1]), jnp.float32)
    y0 = jnp.asarray(rng.standard_normal(A.shape[1]), jnp.float32)
    check_apply("tr_mul", op.tr_mul(x), A, x, F32_TOL)
    check_apply("mul", op.mul(xf), A, xf, F32_TOL, transpose=False)
    check_apply("tr_mul(x, alpha, beta, y)",
                op.tr_mul(x, alpha=1.5, beta=-0.5, y=y0), A, x, F32_TOL,
                alpha=1.5, beta=-0.5, y=y0)

    # chain: alpha scales |A|^T to unit column sums, so the values stay
    # in range; the first-order error bound grows with the step count
    absAT = abs(A.T).astype(np.float64).tocsr()
    alpha = 1.0 / float(np.max(absAT @ np.ones(A.shape[0])))
    got = op.tr_mul_chain(x, chain_iters, alpha)
    want = np.asarray(x, np.float64)
    scale = np.abs(want)
    AT = A.T.astype(np.float64).tocsr()
    for _ in range(chain_iters):
        want = alpha * (AT @ want)
        scale = alpha * (absAT @ scale)
    check(f"tr_mul_chain({chain_iters})", got, want, chain_iters * scale,
          F32_TOL)

    report_memory("tr_mul", xla.tr_spmv, fmt, x)
    report_time(ctx, "tr_mul", lambda: op.tr_mul(x), stream_bytes(fmt))
    if trace:
        k, per_kernel = kernels_per_call(lambda: op.tr_mul(x))
        log(f"  device kernels per tr_mul call: "
            f"{k if k is not None else 'not measured (no GPU plane)'}")
        for name, t in per_kernel.items():
            log(f"    {t:9.2f} us/call  {name}")
    return A, op


def phase_spmm(ctx, L=40_000, k=128):
    import jax.numpy as jnp

    import bench
    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.ops import xla

    log(f"phase 2: SpMM k={k}, bench.blocky_matrix(L={L})")
    A = bench.blocky_matrix(L=L)
    op = VBCOperator.from_csc(A, W=8)
    rng = np.random.default_rng(4)
    X = jnp.asarray(rng.standard_normal((A.shape[0], k)), jnp.float32)
    Xf = jnp.asarray(rng.standard_normal((A.shape[1], k)), jnp.float32)
    check_apply("tr_mul_mat", op.tr_mul_mat(X), A, X, F32_TOL)
    check_apply("mul_mat", op.mul_mat(Xf), A, Xf, F32_TOL, transpose=False)
    fmt = op.device_format("tr")
    report_memory("tr_mul_mat", xla.tr_spmm, fmt, X)
    nbytes = fmt.nbytes + 4 * k * (fmt.m + fmt.n)
    report_time(ctx, "tr_mul_mat", lambda: op.tr_mul_mat(X), nbytes, reps=5)


def phase_2d(ctx, K=160_000, k=32):
    import jax.numpy as jnp

    import bench
    import vbcs_tpu as v
    from vbcs_tpu.operator import VBC2DOperator
    from vbcs_tpu.ops import xla
    from vbcs_tpu.utils.profile import stream_bytes

    log(f"phase 3: 2-D VBC (4x8 tiles), bench.blocky2d_matrix(K={K})")
    A = bench.blocky2d_matrix(K=K)
    t0 = time.perf_counter()
    op = VBC2DOperator.from_csc(
        A, U=4, W=8,
        method=v.AlternatingPacker(v.EquiChunker(8), v.EquiChunker(4)),
        method_forward=v.AlternatingPacker(v.EquiChunker(4),
                                           v.EquiChunker(8)))
    fmt = op.device_format("tr")
    op.device_format("fw")
    log(f"  {A.shape[0]}x{A.shape[1]}, nnz {A.nnz}; set-up (plan + pack + "
        f"device formats, both directions) {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(A.shape[0]), jnp.float32)
    xf = jnp.asarray(rng.standard_normal(A.shape[1]), jnp.float32)
    X = jnp.asarray(rng.standard_normal((A.shape[0], k)), jnp.float32)
    check_apply("tr_mul", op.tr_mul(x), A, x, F32_TOL)
    check_apply("mul", op.mul(xf), A, xf, F32_TOL, transpose=False)
    check_apply(f"tr_mul_mat k={k}", op.tr_mul_mat(X), A, X, F32_TOL)
    report_memory("tr_mul", xla.tr_spmv, fmt, x)
    report_time(ctx, "tr_mul", lambda: op.tr_mul(x), stream_bytes(fmt))


def phase_fem(ctx, k=2048):
    import jax.numpy as jnp

    import bench
    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.ops import xla
    from vbcs_tpu.utils.profile import stream_bytes

    log(f"phase 4: auto-RCM, bench.fem_matrix(k={k})")
    A = bench.fem_matrix(k=k).astype(np.float32)
    t0 = time.perf_counter()
    op = VBCOperator.from_csc(A, W=8, reorder="auto")
    fmt = op.device_format("tr")
    op.device_format("fw")
    log(f"  {A.shape[0]}x{A.shape[1]}, nnz {A.nnz}; set-up "
        f"{time.perf_counter() - t0:.3f} s; RCM applied: "
        f"{op.row_perm is not None}")
    x = jnp.asarray(np.random.default_rng(3).standard_normal(A.shape[0]),
                    jnp.float32)
    check_apply("tr_mul", op.tr_mul(x), A, x, F32_TOL)
    check_apply("mul", op.mul(x), A, x, F32_TOL, transpose=False)
    report_memory("tr_mul kernel", xla.tr_spmv, fmt, x)
    report_time(ctx, "tr_mul", lambda: op.tr_mul(x), stream_bytes(fmt))
    return op.row_perm is not None


def phase_scattered(ctx, A=None):
    import jax.numpy as jnp

    import bench
    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.ops import xla
    from vbcs_tpu.utils.profile import stream_bytes

    A = (bench.scattered_matrix() if A is None else A).astype(np.float32)
    log(f"phase 5: unstructured matrix, {A.shape[0]}x{A.shape[1]}, "
        f"nnz {A.nnz}")
    op = VBCOperator.from_csc(A, W=8)
    fmt = op.device_format("tr")
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.standard_normal(A.shape[0]), jnp.float32)
    xf = jnp.asarray(rng.standard_normal(A.shape[1]), jnp.float32)
    check_apply("tr_mul", op.tr_mul(x), A, x, F32_TOL)
    check_apply("mul", op.mul(xf), A, xf, F32_TOL, transpose=False)
    report_memory("tr_mul", xla.tr_spmv, fmt, x)
    report_time(ctx, "tr_mul", lambda: op.tr_mul(x), stream_bytes(fmt))


def phase_semirings(ctx, A32, op32, corpus=None):
    """fp64 on phase 1's matrix and plans (values cast), int32 on the
    corpus."""
    import dataclasses

    import jax.numpy as jnp

    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.ops import xla
    from vbcs_tpu.utils.profile import stream_bytes

    log("phase 6: fp64 at the phase-1 size, int32 on the corpus")

    def as64(B):
        return dataclasses.replace(B, val=B.val.astype(np.float64))

    op = VBCOperator(m=op32.m, n=op32.n, host_tr=as64(op32.host_tr),
                     host_fw=as64(op32.host_fw))
    A64 = A32.astype(np.float64)
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal(A64.shape[0]), jnp.float64)
    xf = jnp.asarray(rng.standard_normal(A64.shape[1]), jnp.float64)
    y = op.tr_mul(x)
    if y.dtype != jnp.float64:
        raise AssertionError(f"fp64 tr_mul returned {y.dtype}")
    check_apply("fp64 tr_mul", y, A64, x, F64_TOL)
    check_apply("fp64 mul", op.mul(xf), A64, xf, F64_TOL, transpose=False)
    fmt = op.device_format("tr")
    report_memory("fp64 tr_mul", xla.tr_spmv, fmt, x)
    report_time(ctx, "fp64 tr_mul", lambda: op.tr_mul(x), stream_bytes(fmt))

    if corpus is None:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from corpus import load_corpus

        corpus = load_corpus()
    for name, Ac in corpus.items():
        Ai = Ac.copy().astype(np.int32)
        Ai.data = rng.integers(-9, 10, Ai.nnz).astype(np.int32)
        opi = VBCOperator.from_csc(Ai, W=8)
        xi = rng.integers(-9, 10, Ai.shape[0]).astype(np.int32)
        xfi = rng.integers(-9, 10, Ai.shape[1]).astype(np.int32)
        got = np.asarray(opi.tr_mul(jnp.asarray(xi)))
        gotf = np.asarray(opi.mul(jnp.asarray(xfi)))
        want = Ai.T.astype(np.int64) @ xi.astype(np.int64)
        wantf = Ai.astype(np.int64) @ xfi.astype(np.int64)
        if got.dtype != np.int32 or not np.array_equal(got, want):
            raise AssertionError(f"int32 tr_mul on {name} is not exact")
        if not np.array_equal(gotf, wantf):
            raise AssertionError(f"int32 mul on {name} is not exact")
        log(f"  int32 {name}: tr_mul and mul exact")


def phase_four(ctx, L=640_000, k=16, n_devices=4):
    """The distributed path (``parallel/spmv.py``) on a flat mesh of
    ``n_devices``, compared with the single-card operator and scipy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    import bench
    from vbcs_tpu.operator import VBCOperator
    from vbcs_tpu.parallel import spmv as dist

    devices = jax.devices()
    if len(devices) < n_devices:
        raise SystemExit(f"--four needs {n_devices} devices, JAX found "
                         f"{len(devices)}")
    log(f"phase 4-card: parallel.spmv on a flat ('d',) mesh of "
        f"{n_devices} devices, bench.blocky_matrix(L={L})")
    A = bench.blocky_matrix(L=L)
    op = VBCOperator.from_csc(A, W=8)
    mesh = Mesh(np.array(devices[:n_devices]), ("d",))
    tr = dist.shard_vbc(op.device_format("tr"), mesh)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(A.shape[0]), jnp.float32)
    xf = jnp.asarray(rng.standard_normal(A.shape[1]), jnp.float32)
    X = jnp.asarray(rng.standard_normal((A.shape[0], k)), jnp.float32)
    Xf = jnp.asarray(rng.standard_normal((A.shape[1], k)), jnp.float32)
    cases = [
        ("dist_tr_spmv", dist.dist_tr_spmv, x, op.tr_mul, True),
        ("dist_spmv", dist.dist_spmv, xf, op.mul, False),
        ("dist_tr_spmm", dist.dist_tr_spmm, X, op.tr_mul_mat, True),
        ("dist_spmm", dist.dist_spmm, Xf, op.mul_mat, False),
    ]
    for label, fn, xin, single, transpose in cases:
        f = jax.jit(lambda s, v, fn=fn: fn(s, v, mesh))
        got = f(tr, xin)
        check_apply(f"{label} vs scipy", got, A, xin, F32_TOL,
                    transpose=transpose)
        M = abs(A.T if transpose else A).astype(np.float64)
        check(f"{label} vs single-card operator", got,
              np.asarray(single(xin), np.float64),
              2 * (M @ np.abs(np.asarray(xin, np.float64))), F32_TOL)
        report_time(ctx, label, lambda f=f, v=xin: f(tr, v),
                    tr.nbytes + 2 * xin.nbytes, reps=5)


def run_single_card(ctx):
    A, op = phase_1d(ctx)
    phase_spmm(ctx)
    gc.collect()
    phase_2d(ctx)
    gc.collect()
    phase_fem(ctx)
    gc.collect()
    phase_scattered(ctx)
    phase_semirings(ctx, A, op)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card mesh phase")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    from vbcs_tpu.utils.compile_cache import enable_compile_cache
    from vbcs_tpu.utils.profile import (device_fields, gpu_name_power_limit,
                                        peak)

    device = device_fields()
    if device["platform"] != "gpu":
        print(f"chip_smoke.py needs a GPU; JAX's first device is "
              f"{device['platform']!r} ({device['kind']})", file=sys.stderr)
        return 2
    card = gpu_name_power_limit()
    log(f"card (nvidia-smi name, power.limit): {card}")
    log(f"device: {device}")
    log(f"compile cache: {enable_compile_cache(ROOT)}")
    ctx = Context(card.replace("\n", "; "), peak().hbm_bytes_per_s)
    t0 = time.perf_counter()
    if args.four:
        phase_four(ctx)
    else:
        run_single_card(ctx)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
