"""Every float contraction in ops/xla.py asks for Precision.HIGHEST, so
a GPU never computes it in TF32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import vbcs_tpu as v
from corpus import load_corpus
from vbcs_tpu.formats.device import bin_vbc1d, bin_vbc2d
from vbcs_tpu.ops import xla

A = load_corpus()["HB/west0132"].astype(np.float32)


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dot_generals(sub)


CASES = [
    ("tr_spmv", "2d", None),
    ("spmv", "2d", None),
    ("tr_spmm", "1d", 4),
    ("tr_spmm", "2d", 4),
    ("spmm", "1d", 4),
    ("spmm", "2d", 4),
]


@pytest.mark.parametrize("kernel,kind,k", CASES)
def test_contractions_ask_for_highest(kernel, kind, k):
    if kind == "1d":
        fmt = bin_vbc1d(v.vbc1d(A, 4))
    else:
        fmt = bin_vbc2d(v.vbc2d(A, 4, 4, v.AlternatingPacker(
            v.StrictChunker(4), v.StrictChunker(4))))
    n_in = A.shape[0] if kernel.startswith("tr_") else A.shape[1]
    x = jnp.ones((n_in,) if k is None else (n_in, k), jnp.float32)
    jaxpr = jax.make_jaxpr(getattr(xla, kernel))(fmt, x).jaxpr
    dots = list(_dot_generals(jaxpr))
    assert dots, "expected at least one contraction"
    for eqn in dots:
        prec = eqn.params["precision"]
        assert prec is not None and all(
            p == jax.lax.Precision.HIGHEST for p in prec), prec
