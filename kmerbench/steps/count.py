"""``count`` (``k``, optional ``filter``): ``get_kmer_count``; its total is
judged."""


def run(s, step):
    return s.km.get_kmer_count(step["k"], kmer_filter_func=s.kmer_filter(step.get("filter")))
