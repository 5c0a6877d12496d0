"""Method-comparison benchmark harness — the device analog of the
reference's ``bin/test_table.jl``: per matrix, a table of
method x {setup time, memory bytes, runtime, model-predicted cost}.

Usage:
  python bench_tools/test_table.py [--matrix NAME|synthetic] [--w 8]

Columns (mirroring bin/test_table.jl:129):
  method      planner used (CSC baseline first)
  setup_s     plan + pack wall time (host)
  memory_B    packed format bytes (host layout)
  runtime_us  one TrSpMV on the device through the operators' routing
              (``operator.route_tr_spmv`` — the kernel
              ``VBCOperator.tr_mul`` runs for that plan; the route name
              is printed per row), median host-clock time of calls
              that end in ``block_until_ready`` (reference times the
              same ``mul!``, bin/test_table.jl:80)
  model       model-predicted cost for the chosen partition
              (min-memory model value; reference prints its time model)
  pred_us     autotuned-time-model prediction for the partition
              (reference's fidelity column, bin/test_table.jl:82,124 —
              predicted vs measured should agree within ~30%)
  gnnz_s      achieved Gnnz/s
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))


def measure_runtime(fn, reps=10):
    from vbcs_tpu.utils.timing import periter

    return periter(fn, reps=reps)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--matrix", default="synthetic")
    ap.add_argument("--w", type=int, default=8)
    ap.add_argument("--no-time-model", action="store_true")
    ap.add_argument("--no-2d-time-model", action="store_true",
                    help="skip the 2-D autotuned time model (its 8x8 "
                         "microbenchmark grid is expensive on a cold "
                         "cache); the cached 1-D model still provides "
                         "the min-time row")
    ap.add_argument("--no-csc", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    import vbcs_tpu as v
    from vbcs_tpu.models import autotune
    from vbcs_tpu.utils.profile import device_fields, gpu_name_power_limit
    from bench import blocky_matrix

    device = device_fields()
    if device["platform"] != "gpu":
        sys.exit(f"test_table.py measures a GPU; JAX found {device}")
    print(f"device {device}; card {gpu_name_power_limit()}")

    if args.matrix == "synthetic":
        A_sp = blocky_matrix()
        name = "synthetic ct20stif-like (banded blocky)"
    elif args.matrix == "fem":
        from bench import fem_matrix

        A_sp = fem_matrix().astype(np.float64)
        name = "scrambled 5-point FEM (thermal1-like, 320x320 grid)"
    else:
        from corpus import load_corpus

        A_sp = load_corpus()[args.matrix].astype(np.float64)
        name = args.matrix

    A = v.CSC.from_scipy(A_sp)
    W = args.w
    nnz = A.nnz
    print(f"\n=== {name}  {A.m}x{A.n}  nnz={nnz} ===")

    mdl_blocks = v.model_1dvbc_blocks()
    mdl_memory = v.model_1dvbc_memory(4, 8)  # f32 values, int64 host idx
    # (label, planner, objective model for the 'model' column — the
    # reference prints the model-predicted cost of the chosen partition,
    # bin/test_table.jl:82)
    methods = [
        ("strict", v.StrictChunker(W), mdl_memory),
        ("overlap 0.9", v.OverlapChunker(0.9, W), mdl_memory),
        ("min blocks", v.DynamicTotalChunker(
            v.ConstrainedCost(mdl_blocks, v.VertexCount(), W)), mdl_blocks),
        ("min memory", v.DynamicTotalChunker(mdl_memory, W), mdl_memory),
    ]
    mdl_time = None
    if not args.no_time_model:
        try:
            mdl_time = autotune.model_1dvbc_trspmv_time(W)
            methods.append(("min time (autotuned)",
                            v.DynamicTotalChunker(mdl_time, W), mdl_time))
        except Exception as e:
            print(f"[autotune unavailable: {e}]")

    x = jnp.asarray(
        np.random.default_rng(1).standard_normal(A.m), jnp.float32
    )
    want = A_sp.T.astype(np.float64) @ np.asarray(x, np.float64)

    rows = []
    # CSC device baseline (reference src/TrSpMV.jl analog)
    from vbcs_tpu.ops import csr as csr_ops

    cdev = csr_ops.CSCDevice.from_host(A, dtype=np.float32)
    if not args.no_csc:
        f_csc = jax.jit(csr_ops.csc_tr_spmv)
        t_csc = measure_runtime(lambda: f_csc(cdev, x))
    else:
        t_csc = float("nan")
    rows.append(("CSC baseline", 0.0, A.memory_bytes(), t_csc,
                 float("nan"), float("nan")))

    mdl_mem2 = v.model_vbc_memory(4, 8)
    methods_2d = [
        ("strict 2D", v.AlternatingPacker(
            v.StrictChunker(W), v.StrictChunker(W)), mdl_mem2),
        ("overlap 2D 0.7", v.AlternatingPacker(
            v.OverlapChunker(0.7, W), v.OverlapChunker(0.7, W)), mdl_mem2),
        ("dynamic memory 2D", v.default_2d_partitioner(W, W, 4, 8), mdl_mem2),
    ]
    if not args.no_time_model and not args.no_2d_time_model:
        try:
            # autotuned 2-D time model, rank-3 SVD like bin/test_table.jl:56
            mdl_time2 = autotune.model_vbc_trspmv_time(W, W, rank=3)
            methods_2d.append((
                "min time 2D (autotuned)",
                v.AlternatingPacker(
                    v.EquiChunker(1),
                    v.EquiChunker(1),
                    v.DynamicTotalChunker(
                        v.ConstrainedCost(mdl_time2, v.VertexCount(), W)),
                    v.DynamicTotalChunker(
                        v.ConstrainedCost(mdl_time2.permuted(), v.VertexCount(), W)),
                    v.DynamicTotalChunker(
                        v.ConstrainedCost(mdl_time2, v.VertexCount(), W)),
                ),
                mdl_time2,
            ))
        except Exception as e:
            print(f"[2-D autotune unavailable: {e}]")

    from vbcs_tpu.operator import route_tr_spmv

    for label, method, objective in methods:
        t0 = time.perf_counter()
        Phi = v.pack_stripe(A, method)
        B = v.vbc1d(A, W, Phi)
        setup = time.perf_counter() - t0
        # time the kernel VBCOperator.tr_mul runs for this plan
        kname, fmt, call = route_tr_spmv(B)
        f = jax.jit(call)
        y = np.asarray(f(fmt, x), np.float64)
        assert np.allclose(y, want, rtol=1e-4, atol=1e-4 * max(1, np.abs(want).max())), label
        t_run = measure_runtime(lambda: f(fmt, x))
        model_val = v.total_value(A, Phi, objective)
        pred_ns = (v.total_value(A, Phi, mdl_time)
                   if mdl_time is not None else float("nan"))
        rows.append((f"{label} [{kname}]", setup, B.memory_bytes(),
                     t_run, model_val, pred_ns))

    for label, method, objective in methods_2d:
        t0 = time.perf_counter()
        B2 = v.vbc2d(A, W, W, method)
        setup = time.perf_counter() - t0
        kname, fmt2, call2 = route_tr_spmv(B2)
        f2 = jax.jit(call2)
        y = np.asarray(f2(fmt2, x), np.float64)
        assert np.allclose(y, want, rtol=1e-4, atol=1e-4 * max(1, np.abs(want).max())), label
        t_run = measure_runtime(lambda: f2(fmt2, x))
        model_val = (v.total_value(A, B2.Phi, objective, Pi=B2.Pi)
                     + v.row_component_value(B2.Pi, objective))
        rows.append((f"{label} [{kname}]", setup, B2.memory_bytes(),
                     t_run, model_val, float("nan")))

    print(f"{'method':38s} {'setup_s':>8s} {'memory_B':>12s} "
          f"{'runtime_us':>11s} {'gnnz_s':>7s} {'model':>12s} "
          f"{'pred_us':>8s} {'p/m':>5s}")
    for label, setup, mem, t_run, model_val, pred_ns in rows:
        g = nnz / t_run / 1e9 if t_run == t_run else float("nan")
        pred_us = pred_ns / 1e3
        ratio = (pred_us / (t_run * 1e6)
                 if t_run == t_run and pred_ns == pred_ns else float("nan"))
        print(f"{label:38s} {setup:8.3f} {mem:12d} "
              f"{t_run*1e6:11.1f} {g:7.2f} {model_val:12.0f} "
              f"{pred_us:8.1f} {ratio:5.2f}")


if __name__ == "__main__":
    main()
