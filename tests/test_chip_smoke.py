"""chip_smoke.py at tiny sizes on the CPU: every phase function, the
checks it relies on, and its refusal to run without a GPU."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

import bench
import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def ctx():
    return cs.Context()


def test_phase_1d_small(ctx, capsys):
    A, op = cs.phase_1d(ctx, L=300, chain_iters=4)
    out = capsys.readouterr().out
    assert A.nnz > 0 and op.shape == A.shape
    for label in ("tr_mul:", "mul:", "tr_mul(x, alpha, beta, y)",
                  "tr_mul_chain(4)", "memory_analysis", "us/call",
                  "device kernels per tr_mul call: not measured"):
        assert label in out
    assert "FAIL" not in out


def test_phase_spmm_small(ctx, capsys):
    cs.phase_spmm(ctx, L=200, k=8)
    out = capsys.readouterr().out
    assert "tr_mul_mat:" in out and "mul_mat:" in out and "FAIL" not in out


def test_phase_2d_small(ctx, capsys):
    cs.phase_2d(ctx, K=300, k=3)
    out = capsys.readouterr().out
    assert "tr_mul_mat k=3" in out and "FAIL" not in out


def test_phase_fem_small_applies_rcm(ctx, capsys):
    # 80 x 80 grid = 6400 rows: enough 1024-row windows for the
    # scrambled order to trip the auto-RCM locality estimate
    assert cs.phase_fem(ctx, k=80) is True
    assert "RCM applied: True" in capsys.readouterr().out


def test_phase_scattered_small(ctx, capsys):
    A = sp.random(700, 500, 0.004, random_state=3, format="csc")
    cs.phase_scattered(ctx, A)
    assert "FAIL" not in capsys.readouterr().out


def test_phase_semirings_small(ctx, capsys):
    A, op = cs.phase_1d(ctx, L=100, chain_iters=2, trace=False)
    cs.phase_semirings(ctx, A, op)
    out = capsys.readouterr().out
    assert "fp64 tr_mul:" in out and out.count("tr_mul and mul exact") == 6


@pytest.mark.parametrize("ndev", [2, 4])
def test_phase_four_small(cpu_mesh_devices, ctx, capsys, ndev):
    cs.phase_four(ctx, L=200, k=3, n_devices=ndev)
    out = capsys.readouterr().out
    for name in ("dist_tr_spmv", "dist_spmv", "dist_tr_spmm", "dist_spmm"):
        assert f"{name} vs scipy" in out
        assert f"{name} vs single-card operator" in out


def test_check_fails_outside_tolerance(capsys):
    want = np.array([1.0, 2.0, 0.0])
    scale = np.array([1.0, 2.0, 0.0])
    cs.check("exact", want.copy(), want, scale, 1e-5)
    with pytest.raises(AssertionError, match="exceeds tolerance"):
        cs.check("off", want + [0, 1e-3, 0], want, scale, 1e-5)
    with pytest.raises(AssertionError, match="exceeds tolerance"):
        # an empty output column must come out exactly zero
        cs.check("empty", want + [0, 0, 1e-30], want, scale, 1e-5)
    with pytest.raises(AssertionError, match="non-finite"):
        cs.check("nan", np.array([np.nan, 2.0, 0.0]), want, scale, 1e-5)


def test_check_apply_alpha_beta():
    A = sp.random(30, 20, 0.2, random_state=1, format="csc")
    x, y = np.ones(30), np.arange(20.0)
    cs.check_apply("axpby", 2.0 * (A.T @ x) - y, A, x, 1e-12, alpha=2.0,
                   beta=-1.0, y=y)
    with pytest.raises(AssertionError):
        cs.check_apply("wrong", A.T @ x, A, x, 1e-12, alpha=2.0)


def test_main_refuses_cpu(capsys):
    assert cs.main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "needs a GPU" in captured.err


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_script_exits_nonzero_on_cpu():
    p = _run([], ROOT)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "needs a GPU" in p.stderr


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run([], tmp_path)
    assert p.returncode != 0
    for line in p.stdout.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)


def test_bench_2d_generator_makes_dense_tiles():
    K, u, w, d = 200, 4, 8, 3
    A = bench.blocky2d_matrix(K=K, u=u, w=w, d=d, band=50)
    # every stored entry lies in a full u x w tile
    C = A.tocoo()
    tiles = {}
    for r, c in zip(C.row, C.col):
        tiles.setdefault((r // u, c // w), set()).add((r % u, c % w))
    assert all(len(t) == u * w for t in tiles.values())
