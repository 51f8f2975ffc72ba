"""The most device memory the allocator held during the window, on the
fullest card (torch.cuda.max_memory_allocated, reset as the window opens)."""


def read(ctx):
    return ctx.peak_bytes / 2**30
