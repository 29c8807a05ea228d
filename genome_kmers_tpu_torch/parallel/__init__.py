"""The sorted k-mer index on a single-process mesh.

Counterpart of ``genome_kmers_tpu/parallel``: the 1-D mesh (``make_mesh``)
and the 2-D ``(node, local)`` mesh (``make_mesh2``), the sample sorts
(dense, gather, canonical, and the refinement rounds beyond one compare
window), the stitched group statistics, count queries and checkpoints. The
collectives are plain functions over lists of per-shard tensors
(``collectives.py``).

Not ported here: the odd-even merge sort ``distributed_sort_positions``
(ROADMAP.md: not to be ported); multi-process runs over
``torch.distributed`` (ROADMAP.md A11, multi-process) and the ``*_large*``
variants of ``LargeKmers`` (A12).
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
    mesh_lanes_filter_flags,
    mesh_size,
)
from .hier import make_mesh2, sample_sort_positions_ragged_hier
from .query import distributed_count_queries
from .sample_sort import (
    distributed_adjacent_gids,
    sample_sort_canonical_dense_ragged,
    sample_sort_canonical_ragged,
    sample_sort_positions,
    sample_sort_positions_dense_ragged,
    sample_sort_positions_ragged,
    sample_sort_positions_unbounded,
)

__all__ = [
    "AXIS",
    "Mesh",
    "compact_ragged",
    "distributed_adjacent_gids",
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
    "sample_sort_canonical_dense_ragged",
    "sample_sort_canonical_ragged",
    "sample_sort_positions",
    "sample_sort_positions_dense_ragged",
    "sample_sort_positions_ragged",
    "sample_sort_positions_ragged_hier",
    "sample_sort_positions_unbounded",
    "save_kmers_sharded",
    "save_sharded_index",
]
