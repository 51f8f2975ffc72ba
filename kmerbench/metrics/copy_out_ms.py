"""ms a call in copy-outs of results (pipeline.RING.copy_out, which every
to_host on a card takes), from a synchronize on entry to the return, on the
rank that spends most."""


def read(ctx):
    per = [ctx.per_call(r["copy_out_s"]) for r in ctx.ranks if r["copy_out_s"]]
    return 1e3 * max(per) if per else None
