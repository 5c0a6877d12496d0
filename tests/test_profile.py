"""Byte accounting, device peaks and roofline shares (utils/profile)."""

import numpy as np
import pytest
import scipy.sparse as sp

import vbcs_tpu as v
from vbcs_tpu.formats.device import bin_vbc1d, bin_vbc2d
from vbcs_tpu.utils import profile as prof


class FakeDev:
    def __init__(self, kind):
        self.device_kind = kind


H200 = FakeDev("NVIDIA H200")


def _formats():
    A = sp.random(2000, 1500, 0.01, random_state=1, format="csc")
    A = A.astype(np.float32)
    B1 = v.vbc1d(A, 4)
    B2 = v.vbc2d(A, 4, 4, v.AlternatingPacker(v.StrictChunker(4),
                                              v.StrictChunker(4)))
    return bin_vbc1d(B1), bin_vbc2d(B2)


def test_stream_bytes_and_roofline():
    for fmt in _formats():
        b = prof.stream_bytes(fmt)
        expect = 0
        for c in fmt.classes:
            idx = c.row if hasattr(c, "row") else c.rowstart
            expect += c.val.size * 4 + idx.size * 4 + c.seg.size * 4
            expect += c.ycol.size * 4
        assert b == expect + 4 * (fmt.m + fmt.n)
        r = prof.roofline(fmt, measured_s=2 * b / 4.8e12, device=H200)
        assert 0.49 < r.fraction < 0.51
        assert "% of roofline" in str(r)


def test_hbm_table_has_known_generations():
    p = prof.peak(H200)
    assert p.hbm_bytes_per_s == 4.8e12 and p.hbm_bytes == 141e9
    assert "data sheet" in p.source
    assert prof.hbm_bandwidth(H200) == 4.8e12


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 80GB HBM3", None])
def test_peak_raises_on_unknown_device(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        prof.peak(FakeDev(kind))


def test_device_fields_name_the_device():
    import jax

    f = prof.device_fields()
    assert f == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                 "count": len(jax.devices())}
