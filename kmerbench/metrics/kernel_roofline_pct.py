"""% of the memory roofline: a call's bytes (kmerbench/roofline.py: inputs
read once, outputs written once, the whole call's over all its cards) over
the cards' peak bandwidth, against the kernel time a call takes on a card
(torch.profiler, summed over kernels, the mean over the ranks)."""

from kmerbench import roofline


def read(ctx):
    traced = ctx.traced()
    bw = roofline.peak(ctx.kind, "hbm_bytes_per_s")
    if not traced or bw is None:
        return None
    kernel_s = sum(t["kernel_s"] for t in traced) / len(traced) / ctx.calls
    if kernel_s <= 0:
        return None
    s = ctx.sizes
    work = roofline.call_bytes(ctx.bases, ctx.reads, s["rows"], s["words"],
                               ctx.cell.config["upper"], s.get("occurrences", 0))
    return 100 * work / (ctx.chips * bw) / kernel_s
