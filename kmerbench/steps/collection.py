"""``collection``: a new forward-strand ``SequenceCollection`` of the
generated records, on the session's first card."""

import genome_kmers_tpu_torch as gk


def run(s, step):
    s.sc = s.km = None
    seqs = [(name, bases.tobytes().decode("ascii")) for name, bases in s.records]
    s.sc = gk.SequenceCollection(sequence_list=seqs, strands_to_load="forward", device=s.device)
