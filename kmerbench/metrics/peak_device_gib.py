"""torch.cuda.max_memory_allocated() from process start to the window's
end, GiB: what bounds the genome one card holds."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
