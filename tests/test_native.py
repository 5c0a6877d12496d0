"""Native (C++) fast paths must match the NumPy oracles bitwise."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

import vbcs_tpu as v
from vbcs_tpu.formats.csc import CSC
from vbcs_tpu.formats.vbc1d import pack_1dvbc
from vbcs_tpu.native import get_lib
from vbcs_tpu.plan.dynamic import dp_partition

@pytest.fixture(autouse=True)
def native_lib():
    """Decided at run time: the library builds at first use."""
    lib = get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no C++ compiler)")
    return lib


def _rand_csc(m, n, nnz, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = sp.coo_matrix(
        (
            rng.standard_normal(nnz).astype(dtype),
            (rng.integers(0, m, nnz), rng.integers(0, n, nnz)),
        ),
        shape=(m, n),
    ).tocsc()
    A.sum_duplicates()
    A.sort_indices()
    return CSC.from_scipy(A)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_native_dp_matches_numpy(seed):
    A = _rand_csc(500, 700, 3000, seed)
    for model in [
        v.model_1dvbc_memory(8, 8),
        v.model_1dvbc_blocks(),
        v.AffineConnectivityModel(2.0, 0.5, 0.25, 1.0),
        v.AffineFillNetCostModel(24, 0, 8, 8),
    ]:
        s_nat = dp_partition(A, model, 6)
        os.environ["VBCS_NO_NATIVE"] = "1"
        try:
            s_np = dp_partition(A, model, 6)
        finally:
            del os.environ["VBCS_NO_NATIVE"]
        assert s_nat == s_np, type(model).__name__


def test_native_dp_2d_matches_numpy():
    A = _rand_csc(300, 400, 2000, 7)
    Pi = v.SplitPartition.equi(300, 3)
    model = v.model_vbc_memory(8, 8)
    s_nat = dp_partition(A, model, 5, Pi)
    os.environ["VBCS_NO_NATIVE"] = "1"
    try:
        s_np = dp_partition(A, model, 5, Pi)
    finally:
        del os.environ["VBCS_NO_NATIVE"]
    assert s_nat == s_np


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_native_pack_matches_numpy(dtype):
    A = _rand_csc(200, 300, 2500, 11, np.float64)
    A = CSC(m=A.m, n=A.n, pos=A.pos, idx=A.idx, val=A.val.astype(dtype))
    Phi = v.pack_stripe(A, v.EquiChunker(5))
    B_nat = pack_1dvbc(A, Phi, 5)
    os.environ["VBCS_NO_NATIVE"] = "1"
    try:
        B_np = pack_1dvbc(A, Phi, 5)
    finally:
        del os.environ["VBCS_NO_NATIVE"]
    assert np.array_equal(B_nat.pos, B_np.pos)
    assert np.array_equal(B_nat.idx, B_np.idx)
    assert np.array_equal(B_nat.ofs, B_np.ofs)
    assert np.array_equal(B_nat.val, B_np.val)
    assert B_nat.val.dtype == B_np.val.dtype


def test_library_is_built_under_a_source_hash(native_lib):
    from vbcs_tpu import native

    so = native._so_path()
    assert os.path.dirname(so) == native._BUILD_DIR
    assert os.path.exists(so)
    with open(native._SRC, "rb") as f:
        import hashlib

        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    assert os.path.basename(so) == f"libvbcnative-{digest}.so"


def test_edited_source_gets_a_new_library(monkeypatch, tmp_path):
    from vbcs_tpu import native

    src = tmp_path / "vbc_native.cpp"
    src.write_bytes(open(native._SRC, "rb").read() + b"// edited\n")
    before = native._so_path()
    monkeypatch.setattr(native, "_SRC", str(src))
    assert native._so_path() != before


def test_build_is_generic_and_atomic(monkeypatch, tmp_path):
    """No -march=native (the library must load on another CPU), and the
    library appears under its final name only once complete."""
    from vbcs_tpu import native

    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"ELF")

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", fake_run)
    so = str(tmp_path / "libvbcnative-x.so")
    assert native._build(so)
    assert not any("march" in a for a in cmds[0])
    assert cmds[0][cmds[0].index("-o") + 1] != so
    assert os.listdir(tmp_path) == ["libvbcnative-x.so"]


def test_failed_build_warns(monkeypatch, tmp_path):
    from vbcs_tpu import native

    def failing_run(cmd, **kw):
        raise native.subprocess.CalledProcessError(1, cmd, stderr=b"boom")

    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native.subprocess, "run", failing_run)
    with pytest.warns(RuntimeWarning, match="boom"):
        assert not native._build(str(tmp_path / "lib.so"))
    assert os.listdir(tmp_path) == []


def test_build_dir_is_git_ignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "vbcs_tpu/native/_build/" in f.read().split()
