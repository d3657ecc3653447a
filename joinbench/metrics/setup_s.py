"""setup_s: seconds from process start to the first join of the window
(the data from the seed, the index build, the kernels loaded, one warm join)."""


def read(ctx):
    return ctx.setup_s
