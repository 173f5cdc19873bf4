"""peak_mem_gib (GiB, host clock reading of the allocator):
`torch.cuda.max_memory_allocated` over set-up and window."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
