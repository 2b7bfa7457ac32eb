"""Device milliseconds of the kernels inside the program's decoder spans
(``link.viterbi``, ``link.ldpc_decode``), per Mbit of information bits
simulated."""

SPANS = ("link.viterbi", "link.ldpc_decode")


def read(ctx):
    found = [s for s in map(ctx.trace.span_kernel_s, SPANS) if s is not None]
    if not found or not ctx.info_bits:
        return None
    return sum(found) * 1e3 / (ctx.info_bits / 1e6)
