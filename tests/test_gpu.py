"""Tests that need a GPU.  They skip elsewhere (through the ``gpu``
fixture, decided at run time) and run on the card with

    VBCS_TEST_ON_GPU=1 python -m pytest tests/ -m gpu -n 0
"""

import numpy as np
import pytest

import chip_smoke as cs

pytestmark = pytest.mark.gpu


def test_device_is_in_the_peak_table(gpu):
    from vbcs_tpu.utils.profile import peak

    assert peak(gpu).hbm_bytes_per_s > 0


def test_smoke_phases_on_the_card(gpu, capsys):
    ctx = cs.Context()
    A, op = cs.phase_1d(ctx, L=20_000, chain_iters=5)
    cs.phase_spmm(ctx, L=4_000, k=32)
    cs.phase_2d(ctx, K=5_000, k=8)
    cs.phase_semirings(ctx, A, op)
    out = capsys.readouterr().out
    assert "FAIL" not in out
    kernels = [line for line in out.splitlines()
               if "device kernels per tr_mul call" in line]
    assert kernels and "not measured" not in kernels[0]
    assert np.isfinite(np.asarray(op.tr_mul(np.ones(A.shape[0], "f4")))).all()
