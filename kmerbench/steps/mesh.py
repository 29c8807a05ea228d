"""``mesh``: the single-process mesh over the session's cards, one shard a
card (``parallel.make_mesh(devices=s.devices)``), as ``s.mesh``."""

from genome_kmers_tpu_torch.parallel import make_mesh


def run(s, step):
    s.mesh = make_mesh(devices=s.devices)
