"""The reference side of the ``mesh_index`` step (``steps/mesh_index.py``):
the forward strand's sorted (``min``, ``max``) index of the records,
checked in blocks of rows on the judge's devices (``reference/blocked.py``)
with the counts of ``kmers_ref.check_index``."""

from kmerbench.reference import blocked


def genome(records) -> blocked.Genome:
    return blocked.Genome(records)


def rows(g, step) -> int:
    return g.kmer_count(step["min"])


def check(g, pos, step):
    """(counts of what is wrong with ``pos``, the ``blocked.Index`` over it)."""
    return blocked.check_index(g, pos, step["min"], step["max"])


def control(g, pos, step, timed: bool, bits: int):
    """The control's index, and whether the answers over it are the
    reference's (True) or the control's own (False): an index built in the
    window (``timed``) is replaced by one ordered by a ``bits``-bit
    fingerprint (breaks "exact"); an index of the set-up stays the
    program's and the answers break "exact"."""
    if not timed:
        return pos, False
    return blocked.control_index_fingerprint(g, step["min"], step["max"], bits), False
