"""Device milliseconds of the kernels inside the program's
``link.polar_decode`` spans, per Mbit of information bits simulated."""


def read(ctx):
    s = ctx.trace.span_kernel_s("link.polar_decode")
    if s is None or not ctx.info_bits:
        return None
    return s * 1e3 / (ctx.info_bits / 1e6)
