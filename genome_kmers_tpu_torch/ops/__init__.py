"""Tensor operations of the PyTorch k-mer engine.

Counterpart of ``genome_kmers_tpu/ops``. Modules (import directly as
needed):

- ``encoding``  — 4-bit IUPAC / 2-bit ACGT rank encodings, complement tables
- ``keys``      — packed key-word construction, segment math, caps, the
                  strided-pack expansions
- ``sort``      — single-device sorts (one window, refinement rounds) and
                  adjacent-boundary masks
- ``groups``    — segmented group geometry, histograms, selection masks
- ``filters``   — vectorized filter masks, flag planes, scalar parity
- ``canonical`` — strand-collapsed (min(kmer, revcomp)) keys and sorting
- ``query``     — binary-search count queries
- ``large``     — the strided pack and int64 positions of ``LargeKmers``
- ``hybrid``    — sparse-ambiguity 2-bit/4-bit split sort (opt-in)
- ``chunked``   — two-level chunked sort of one device (opt-in)

The JAX package's ``pallas_kernels`` and ``pallas_sort`` have their
counterparts in ``genome_kmers_tpu_torch/kernels`` (CUDA sources in
``csrc``).
"""
