"""``mesh_group_counts`` (``k``): ``get_kmer_group_counts(k, mesh=s.mesh)`` at
the library's defaults; its (histogram, total) is judged."""


def run(s, step):
    return s.km.get_kmer_group_counts(step["k"], mesh=s.mesh)
