"""The reference side of the ``index`` step (``steps/index.py``): the
forward strand's sorted (``min``, ``max``) index of the records."""

from kmerbench.reference import kmers_ref as ref

CONTROL_DEPTH = 32  # the suffix control compares this many bases, then positions


def genome(records) -> ref.Genome:
    return ref.Genome(records)


def rows(g, step) -> int:
    return g.kmer_count(step["min"])


def check(g, pos, step):
    """(counts of what is wrong with ``pos``, the ``Index`` over it)."""
    return ref.check_index(g, pos, step["min"], step["max"])


def control(g, pos, step, timed: bool, bits: int):
    """The control's index, and whether the answers over it are the
    reference's (True) or the control's own (False). An index built in the
    window (``timed``) is replaced: at a bounded length by one ordered by a
    ``bits``-bit fingerprint (breaks "exact"), in suffix order by the
    order compared to CONTROL_DEPTH bases only (breaks "order"). An index
    of the set-up stays the program's and the answers break "exact"."""
    if not timed:
        return pos, False
    if step["max"] is not None:
        return ref.control_index_fingerprint(g, step["min"], step["max"], bits), False
    errs, ix = check(g, pos, step)
    if errs["unordered_pairs"]:
        raise ValueError("the suffix control starts from a verified order")
    return ref.control_index_truncated(ix, CONTROL_DEPTH), True
