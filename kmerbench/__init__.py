"""kmerbench: the benchmark of genome_kmers_tpu_torch on an NVIDIA GPU.

Run one cell with ``python3 kmerbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; see README.md.
"""
