"""The sorted k-mer index on a one-dimensional, single-process mesh.

Counterpart of ``genome_kmers_tpu/parallel`` at a bounded k-mer length: the
mesh (``make_mesh``), the sample sort (dense and gather), the stitched group
statistics, count queries and checkpoints. The collectives are plain
functions over lists of per-shard tensors (``collectives.py``).

Not ported yet (ROADMAP.md A11): the unbounded and beyond-window mesh sort,
canonical statistics on a mesh, the 2-D hierarchical mesh
(``parallel/hier.py``) and multi-process runs over ``torch.distributed``;
the ``LargeKmers`` variants wait for A12.
"""

from .checkpoint import (
    load_kmers_sharded,
    load_sharded_index,
    save_kmers_sharded,
    save_sharded_index,
)
from .distributed import (
    AXIS,
    Mesh,
    compact_ragged,
    distributed_group_size_histogram,
    distributed_group_size_histogram_ragged,
    distributed_hist_from_sizes,
    make_mesh,
    make_mesh2,
    mesh_lanes_filter_flags,
    mesh_size,
)
from .query import distributed_count_queries
from .sample_sort import (
    sample_sort_positions,
    sample_sort_positions_dense_ragged,
    sample_sort_positions_ragged,
)

__all__ = [
    "AXIS",
    "Mesh",
    "compact_ragged",
    "distributed_count_queries",
    "distributed_group_size_histogram",
    "distributed_group_size_histogram_ragged",
    "distributed_hist_from_sizes",
    "load_kmers_sharded",
    "load_sharded_index",
    "make_mesh",
    "make_mesh2",
    "mesh_lanes_filter_flags",
    "mesh_size",
    "sample_sort_positions",
    "sample_sort_positions_dense_ragged",
    "sample_sort_positions_ragged",
    "save_kmers_sharded",
    "save_sharded_index",
]
