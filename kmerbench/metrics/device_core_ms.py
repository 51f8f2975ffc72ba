"""ms a call in the device core: the program's "key build", "radix sort" and
"fused count" spans (pipeline._count_core, each timed on the card by CUDA
events), on the rank that spends most. None where a call took another
route (the fused sort's "fused sort" span)."""

SPANS = ("key build", "radix sort", "fused count")


def read(ctx):
    best = None
    for r in ctx.ranks:
        per = [sum(c[name] for name in SPANS) for c in r["spans"]
               if all(name in c for name in SPANS)]
        if per:
            best = max(best or 0.0, 1e3 * ctx.per_call(per))
    return best
