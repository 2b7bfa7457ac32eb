"""K2, the Viterbi traceback kernel: its least time over the traced
window (``bounds.k2_bound`` with every position's full walk, F frames a
link step) as a share of the device time of ``traceback_kernel``."""
from portbench import bounds

KERNELS = ("traceback_kernel",)


def read(ctx):
    c = ctx.ref.chain
    T = getattr(c, "steps", None)
    t = ctx.trace.kernel_s(*KERNELS)
    if T is None or not t or not ctx.steps:
        return None
    nbytes, ops = bounds.k2_bound(ctx.frames, T, c.states,
                                  ctx.frames * bounds.k2_steps(T, c.tb_depth))
    return (100.0 * ctx.steps
            * bounds.bound_s(nbytes, ops, bounds.INT32_OPS_PER_S) / t)
