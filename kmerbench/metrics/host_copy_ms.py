"""ms a call in which the host copies results out of the pinned blocks into
their fresh arrays: the program's "copy-out host copy" span
(pipeline.CopyRing.copy_out, summed over a result's pieces), on the rank
that spends most."""


def read(ctx):
    best = None
    for r in ctx.ranks:
        per = [c["copy-out host copy"] for c in r["spans"] if "copy-out host copy" in c]
        if per:
            best = max(best or 0.0, 1e3 * ctx.per_call(per))
    return best
