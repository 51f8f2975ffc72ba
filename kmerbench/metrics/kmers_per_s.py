"""k-mers a second: the valid k-mer starts of every call in the window (the
global read set's on several cards), over the window (host clock)."""


def read(ctx):
    return ctx.kmers_per_call * ctx.calls / ctx.window_s
