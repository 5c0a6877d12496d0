"""vbcs_tpu — variable-block sparse linear algebra on accelerators.

A from-scratch JAX/XLA framework with the capabilities of
SparseMatrixVBCs.jl (arXiv:2005.12414): 1-D and 2-D Variable Block Column
sparse formats, optimal-partitioning DP planners over pluggable cost
models (block count / memory / autotuned execution time), heuristic
chunkers, SpMV / transposed-SpMV / SpMM kernels, and multi-device
execution over a `jax.sharding.Mesh`.

Layering (see SURVEY.md for the reference map):

* ``formats``  — CSC ingest, host VBC1D/VBC2D containers (exact-semantics
  NumPy oracles), static-shape width-class device formats.
* ``plan``     — Equi/Strict/Overlap chunkers, the DynamicTotalChunker
  optimal DP, AlternatingPacker 2-D optimization.
* ``models``   — cost models + the on-device autotuned time model.
* ``ops``      — XLA (jnp) compute kernels.
* ``parallel`` — shard_map distribution across a device mesh.
* ``native``   — C++ fast paths (converter, DP planner) via ctypes.
"""

from .api import (
    default_1d_partitioner,
    default_2d_partitioner,
    vbc1d,
    vbc2d,
)
from .formats.csc import CSC
from .formats.partition import MapPartition, SplitPartition
from .formats.vbc1d import VBC1D, pack_1dvbc
from .formats.vbc2d import VBC2D, pack_vbc2d
from .models.cost import (
    AffineConnectivityModel,
    AffineFillNetCostModel,
    BlockComponentCostModel,
    ColumnBlockComponentCostModel,
    ConstrainedCost,
    Line,
    VertexCount,
    model_1dvbc_blocks,
    model_1dvbc_memory,
    model_vbc_blocks,
    model_vbc_memory,
    row_component_value,
    total_value,
)
from .models.autotune import (
    autotune_1dvbc_trspmv,
    autotune_vbc_trspmv,
    model_1dvbc_trspmv_time,
    model_vbc_trspmv_time,
)
from .plan.alternating import (
    AlternatePacker,
    AlternatingPacker,
    pack_plaid,
    pack_stripe,
)
from .operator import VBC2DOperator, VBCOperator
from .plan.chunkers import EquiChunker, OverlapChunker, StrictChunker
from .plan.dynamic import DynamicTotalChunker
from .plan.jax_dp import dp_partition_jit
from .plan.reorder import profile_rows, rcm_rows

__version__ = "0.1.0"
