"""Kernels launched by a filtered ``get_kmer_group_counts`` call, counted
in the device trace, the mean over the session's filtered calls."""

from kmerbench.record import spans_of


def read(run):
    spans = spans_of(run, "group_counts", "call", filtered=True)
    if not spans or run.device is None:
        return None
    return sum(run.device.kernels_in(s.start, s.end) for s in spans) / len(spans)
