"""ms a call in the supermer route's "exchange" span (the all_to_all, ended
by a synchronize), on the rank that spends most."""


def read(ctx):
    per = [ctx.per_call([c["exchange"] for c in r["spans"] if "exchange" in c])
           for r in ctx.ranks]
    per = [p for p in per if p is not None]
    return 1e3 * max(per) if per else None
