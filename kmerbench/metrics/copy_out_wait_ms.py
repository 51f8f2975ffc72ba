"""ms a call in which the host waits for the pieces of results to arrive in
the pinned blocks: the program's "copy-out wait" span
(pipeline.CopyRing.copy_out, summed over a result's pieces), on the rank
that spends most."""


def read(ctx):
    best = None
    for r in ctx.ranks:
        per = [c["copy-out wait"] for c in r["spans"] if "copy-out wait" in c]
        if per:
            best = max(best or 0.0, 1e3 * ctx.per_call(per))
    return best
