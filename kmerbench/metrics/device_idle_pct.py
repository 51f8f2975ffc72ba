"""% of the traced window in which no kernel, copy or memset ran on the
card (torch.profiler), the mean over the ranks."""


def read(ctx):
    traced = ctx.traced()
    if not traced:
        return None
    return 100 * sum(1 - t["busy_s"] / t["window_s"] for t in traced) / len(traced)
