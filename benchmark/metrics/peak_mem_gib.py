"""``torch.cuda.max_memory_allocated`` over the window, GiB."""


def read(ctx):
    return ctx.peak_mem_bytes / 2**30 if ctx.peak_mem_bytes else None
