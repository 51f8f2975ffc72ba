"""ms a call in the supermer route's "pack" span (feed + plan + encode,
parallel/supermer_route), on the rank that spends most."""


def read(ctx):
    per = [ctx.per_call([c["pack"] for c in r["spans"] if "pack" in c]) for r in ctx.ranks]
    per = [p for p in per if p is not None]
    return 1e3 * max(per) if per else None
