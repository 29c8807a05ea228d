"""``group_counts`` (``k``, optional ``filter`` = [name, *args]):
``get_kmer_group_counts`` at the library's defaults; its (histogram,
total) is judged."""


def run(s, step):
    return s.km.get_kmer_group_counts(step["k"], kmer_filter_func=s.kmer_filter(step.get("filter")))
