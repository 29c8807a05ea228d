"""The sorted k-mer index on a mesh, within one process or across processes.

Counterpart of ``genome_kmers_tpu/parallel``: the 1-D mesh (``make_mesh``)
and the 2-D ``(node, local)`` mesh (``make_mesh2``), the sample sorts
(dense, gather, canonical, and the refinement rounds beyond one compare
window), the stitched group statistics, count queries and checkpoints, and
their ``*_large*`` variants over a strided pack and int64 positions, which
``LargeKmers`` runs (``large.py`` holds its statistics). The collectives are
functions over lists of per-shard tensors (``collectives.py``): plain moves
within one process, a ``torch.distributed`` process group (NCCL on cards,
Gloo through the host) where the mesh spans processes, the counterpart of
the JAX package's multi-process meshes. ``distributed_sort_positions``
is the JAX package's opt-in odd-even merge sort of a 1-D mesh.
"""

from .checkpoint import (
    load_kmers_sharded,
    load_large_kmers,
    load_sharded_index,
    save_kmers_sharded,
    save_large_kmers,
    save_sharded_index,
)
from .distributed import (
    AXIS,
    Mesh,
    compact_ragged,
    distributed_group_size_histogram,
    distributed_group_size_histogram_ragged,
    distributed_hist_from_sizes,
    distributed_sort_positions,
    make_mesh,
    mesh_lanes_filter_flags,
    mesh_size,
    process_group,
)
from .hier import make_mesh2, sample_sort_positions_ragged_hier
from .large import (
    distributed_group_size_histogram_large_ragged,
    large_lanes_filter_flags,
    rebuild_large_lanes,
)
from .query import distributed_count_queries, distributed_count_queries_large
from .sample_sort import (
    distributed_adjacent_gids,
    distributed_adjacent_gids_large,
    sample_sort_canonical_dense_ragged,
    sample_sort_canonical_large_ragged,
    sample_sort_canonical_ragged,
    sample_sort_positions,
    sample_sort_positions_dense_ragged,
    sample_sort_positions_large,
    sample_sort_positions_large_ragged,
    sample_sort_positions_large_unbounded,
    sample_sort_positions_ragged,
    sample_sort_positions_unbounded,
)

__all__ = [
    "AXIS",
    "Mesh",
    "compact_ragged",
    "distributed_adjacent_gids",
    "distributed_adjacent_gids_large",
    "distributed_count_queries",
    "distributed_count_queries_large",
    "distributed_group_size_histogram",
    "distributed_group_size_histogram_large_ragged",
    "distributed_group_size_histogram_ragged",
    "distributed_hist_from_sizes",
    "distributed_sort_positions",
    "large_lanes_filter_flags",
    "load_kmers_sharded",
    "load_large_kmers",
    "load_sharded_index",
    "make_mesh",
    "make_mesh2",
    "mesh_lanes_filter_flags",
    "mesh_size",
    "process_group",
    "rebuild_large_lanes",
    "sample_sort_canonical_dense_ragged",
    "sample_sort_canonical_large_ragged",
    "sample_sort_canonical_ragged",
    "sample_sort_positions",
    "sample_sort_positions_dense_ragged",
    "sample_sort_positions_large",
    "sample_sort_positions_large_ragged",
    "sample_sort_positions_large_unbounded",
    "sample_sort_positions_ragged",
    "sample_sort_positions_ragged_hier",
    "sample_sort_positions_unbounded",
    "save_kmers_sharded",
    "save_large_kmers",
    "save_sharded_index",
]
