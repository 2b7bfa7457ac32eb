"""K1, the Viterbi ACS kernel: its least time over the traced window
(``bounds.k1_bound`` for every link step's decode, F frames of T steps)
as a share of the device time of the kernels named ``acs_*``."""
from portbench import bounds

KERNELS = ("acs_warp_kernel", "acs_forward_kernel")


def read(ctx):
    c = getattr(ctx.ref.chain, "steps", None)
    t = ctx.trace.kernel_s(*KERNELS)
    if c is None or not t or not ctx.steps:
        return None
    nbytes, ops = bounds.k1_bound(ctx.frames, c, ctx.ref.chain.n_out,
                                  ctx.ref.chain.states)
    return 100.0 * ctx.steps * bounds.bound_s(nbytes, ops) / t
