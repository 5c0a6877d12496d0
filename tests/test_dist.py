"""The distributed path (``parallel/spmv.py``: block streams sharded over
a flat mesh, x replicated, psum) on the virtual CPU mesh, against
scipy, at 2, 4 and 8 devices, for 1-D and 2-D device formats."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import vbcs_tpu as v
from corpus import load_corpus
from vbcs_tpu.formats.device import bin_vbc1d, bin_vbc2d
from vbcs_tpu.parallel import spmv as dist

A = load_corpus()["LPnetlib/lp_blend"].astype(np.float64)

CASES = {
    # name: (function, transpose?, rhs columns or None)
    "dist_tr_spmv": (dist.dist_tr_spmv, True, None),
    "dist_spmv": (dist.dist_spmv, False, None),
    "dist_tr_spmm": (dist.dist_tr_spmm, True, 6),
    "dist_spmm": (dist.dist_spmm, False, 6),
}


def _format(kind):
    if kind == "1d":
        return bin_vbc1d(v.vbc1d(A, 8))
    return bin_vbc2d(v.vbc2d(A, 4, 4, v.AlternatingPacker(
        v.StrictChunker(4), v.StrictChunker(4))))


@pytest.mark.parametrize("kind", ["1d", "2d"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_dist_matches_scipy(cpu_mesh_devices, ndev, case, kind):
    fn, transpose, k = CASES[case]
    mesh = Mesh(np.array(cpu_mesh_devices[:ndev]), ("d",))
    sdev = dist.shard_vbc(_format(kind), mesh)
    M = A.T if transpose else A
    rng = np.random.default_rng(ndev)
    shape = (M.shape[1],) if k is None else (M.shape[1], k)
    x = rng.standard_normal(shape)
    got = jax.jit(lambda s, xx: fn(s, xx, mesh))(sdev, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), M @ x, rtol=1e-10,
                               atol=1e-10)
