"""``mesh_sort``: ``Kmers.sort(mesh=s.mesh)``, the sample sort over the mesh."""


def run(s, step):
    s.km.sort(mesh=s.mesh, on_round=s.on_round)
