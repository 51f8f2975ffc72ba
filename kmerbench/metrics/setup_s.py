"""Seconds from the process's start to the window's: imports, the kernel
libraries, the reads made and copied to the host, the warm-up call (host
clock; on several cards, the spawning of the ranks too)."""


def read(ctx):
    return ctx.setup_s
