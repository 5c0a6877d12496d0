"""Host-clock timing of device work.

JAX dispatch is asynchronous: a call returns once the work is enqueued.
Each timed call therefore ends in ``jax.block_until_ready``, so the host
clock spans the device's execution of that call.  Warm-up calls run
first, so compilation is never inside the timed window.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["periter"]


def periter(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median seconds per call of ``fn()`` over ``reps`` calls, each
    ending in ``block_until_ready`` on its result."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
