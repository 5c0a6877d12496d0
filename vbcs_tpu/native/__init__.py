"""ctypes bindings for the C++ fast paths (built with g++ at first use).

Set ``VBCS_NO_NATIVE=1`` to force the pure-NumPy implementations.
The shared library is built from ``vbc_native.cpp`` into ``_build/``
(git-ignored) under a name carrying a hash of the source, so an edited
source is rebuilt and a library built elsewhere is never loaded.  It is
compiled for the generic target of the host architecture (no
``-march=native``), so a checkout moved to another CPU still runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import warnings

import numpy as np

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "vbc_native.cpp")
_BUILD_DIR = os.path.join(_HERE, "_build")
_lock = threading.Lock()
_lib = None
_failed = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libvbcnative-{digest}.so")


def _build(so: str) -> bool:
    """Compile to a temporary name, then rename: concurrent first users
    (test workers) never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        warnings.warn(
            f"native library build failed ({e}); using the NumPy paths. "
            f"{detail.decode(errors='replace')[-2000:]}",
            RuntimeWarning,
        )
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _failed
    if os.environ.get("VBCS_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _failed:
            return _lib
        so = _so_path()
        if not os.path.exists(so) and not _build(so):
            _failed = True
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            warnings.warn(f"native library load failed ({e}); using the "
                          "NumPy paths.", RuntimeWarning)
            _failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.dp_partition.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, ctypes.c_int64, f64p, f64p, f64p, f64p,
            f64p, i64p, i64p,
        ]
        lib.pack_1dvbc_count.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p,
            ctypes.c_int64, i64p, i64p, i64p,
        ]
        lib.pack_1dvbc_fill.argtypes = [
            ctypes.c_int64, ctypes.c_int64, i64p, i64p, f64p,
            ctypes.c_int64, i64p, i64p, i64p, i64p, f64p,
        ]
        lib.overlap_chunk.argtypes = [
            ctypes.c_int64, i64p, i64p, ctypes.c_double, ctypes.c_int64,
            i64p, i64p,
        ]
        for fn in (lib.dp_partition, lib.pack_1dvbc_count,
                   lib.pack_1dvbc_fill, lib.overlap_chunk):
            fn.restype = None
        _lib = lib
        return _lib


def _p64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _pf64(a):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dp_partition_native(
    n, num_groups, pos, grp, W, alpha_tab, beta_tabs, gamma_tab, weights,
    delta_tab=None,
):
    """Run the native DP; returns split points or None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    grp = np.ascontiguousarray(grp, dtype=np.int64)
    alpha_tab = np.ascontiguousarray(alpha_tab, dtype=np.float64)
    beta_tabs = np.ascontiguousarray(beta_tabs, dtype=np.float64)
    R = beta_tabs.shape[0] if beta_tabs.ndim == 2 else 1
    beta_flat = beta_tabs.reshape(-1)
    g = (
        np.ascontiguousarray(gamma_tab, dtype=np.float64)
        if gamma_tab is not None
        else None
    )
    wts = (
        np.ascontiguousarray(weights, dtype=np.float64).reshape(-1)
        if weights is not None
        else None
    )
    d = (
        np.ascontiguousarray(delta_tab, dtype=np.float64)
        if delta_tab is not None
        else None
    )
    out_spl = np.zeros(n + 2, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    lib.dp_partition(
        int(n),
        int(max(num_groups, 1)),
        _p64(pos),
        _p64(grp),
        int(W),
        int(R),
        _pf64(alpha_tab),
        _pf64(beta_flat),
        _pf64(g),
        _pf64(wts),
        _pf64(d),
        _p64(out_spl),
        _p64(out_len),
    )
    return out_spl[: int(out_len[0])]


def pack_1dvbc_native(m, n, pos, idx, val, spl):
    """Native two-pass CSC->1D-VBC (float64 values); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    val64 = np.ascontiguousarray(val, dtype=np.float64)
    spl = np.ascontiguousarray(spl, dtype=np.int64)
    L = spl.size - 1
    bpos = np.zeros(L + 1, dtype=np.int64)
    bofs = np.zeros(L + 1, dtype=np.int64)
    lib.pack_1dvbc_count(
        int(m), int(n), _p64(pos), _p64(idx), int(L), _p64(spl),
        _p64(bpos), _p64(bofs),
    )
    out_idx = np.zeros(int(bpos[-1]), dtype=np.int64)
    out_val = np.zeros(int(bofs[-1]), dtype=np.float64)
    lib.pack_1dvbc_fill(
        int(m), int(n), _p64(pos), _p64(idx), _pf64(val64), int(L),
        _p64(spl), _p64(bpos), _p64(bofs), _p64(out_idx), _pf64(out_val),
    )
    return bpos, out_idx, bofs, out_val


def overlap_chunk_native(n, pos, idx, rho, w_max):
    """Native greedy overlap chunker; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out_spl = np.zeros(n + 2, dtype=np.int64)
    out_len = np.zeros(1, dtype=np.int64)
    lib.overlap_chunk(
        int(n), _p64(pos), _p64(idx), float(rho), int(w_max),
        _p64(out_spl), _p64(out_len),
    )
    return out_spl[: int(out_len[0])]
