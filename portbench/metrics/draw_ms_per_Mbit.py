"""Device milliseconds of the kernels inside the program's ``link.draw``
spans (the random bits and noise of each link step), per Mbit of
information bits simulated."""


def read(ctx):
    s = ctx.trace.span_kernel_s("link.draw")
    if s is None or not ctx.info_bits:
        return None
    return s * 1e3 / (ctx.info_bits / 1e6)
