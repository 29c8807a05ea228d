"""Process start to the first timed job or call: the genome made from the
seed, the program's build or load, the mix's set-up and one warm pass."""


def read(run):
    return run.setup_s
