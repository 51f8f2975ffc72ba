"""ms a call in the host feed: the program's "staging" and "host pack" spans
(pipeline.stage_wire), on the rank that spends most."""


def read(ctx):
    best = None
    for r in ctx.ranks:
        per = [c["staging"] + c["host pack"] for c in r["spans"]
               if "staging" in c and "host pack" in c]
        if per:
            best = max(best or 0.0, 1e3 * ctx.per_call(per))
    return best
