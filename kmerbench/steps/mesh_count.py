"""``mesh_count`` (``k``): ``get_kmer_count(k, mesh=s.mesh)``; its total is
judged."""


def run(s, step):
    return s.km.get_kmer_count(step["k"], mesh=s.mesh)
