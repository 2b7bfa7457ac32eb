"""K7, the polar list decoder: its least time over the traced window (every
link step's decode of F frames, counted from the configuration by the
plain reference: the code length, the list size, the info and payload
bits; ``bounds_k7.k7_bound``) as a share of the device time of the
kernels whose name holds ``polar_scl``.  K7 is bound by latency, so this
reads low."""
from portbench import bounds_k7

KERNELS = ("polar_scl",)


def read(ctx):
    c = ctx.ref.chain
    N = getattr(c, "N", None)
    t = ctx.trace.kernel_s(*KERNELS)
    if N is None or not t or not ctx.steps:
        return None
    least = bounds_k7.k7_bound_s(ctx.steps * ctx.frames, N, c.list_size,
                                 c.k_total, c.frame_bits)
    return 100.0 * least / t
